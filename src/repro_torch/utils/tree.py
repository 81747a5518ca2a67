"""Tree utilities (counterpart of ``repro.utils.tree``): named walks over
parameter trees, their sizes, casts and zeros, and the global norm that
gradient clipping takes.  A tree is nested dicts, lists, tuples and
NamedTuples with tensor leaves; a leaf's name joins its keys, list indices
and NamedTuple field names with "/" (e.g. ``layers/0/attn/wq``), as the
reference names them."""

from __future__ import annotations

import math
from typing import Any, Callable

import torch


def tree_flatten_with_names(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten a tree into (slash/separated/name, leaf) pairs, in order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, sub in items:
        out += tree_flatten_with_names(sub, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_map_with_names(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """Map ``fn(name, leaf) -> leaf`` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[tree_map_with_names(fn, v, f"{prefix}/{k}" if prefix else k)
                            for k, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_names(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn(leaf, *leaves)`` over ``tree`` and trees of its structure,
    keeping the structure (dicts, lists, tuples, NamedTuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree, in the order of ``tree_flatten_with_names``."""
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def _leaf_nbytes(x: Any) -> int:
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    if hasattr(x, "shape") and hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    return 0


def tree_size_bytes(tree: Any) -> int:
    """Total bytes across all tensor leaves (meta tensors too)."""
    return sum(_leaf_nbytes(x) for x in tree_leaves(tree))


def tree_num_params(tree: Any) -> int:
    """Total element count across all tensor leaves."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree) if hasattr(x, "shape"))


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating (or complex) leaf to ``dtype``; others stay."""
    def cast(x):
        if isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex()):
            return x.to(dtype)
        return x
    return tree_map(cast, tree)


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_global_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm over all leaves (f32 accumulation): the square root
    of the sum of each leaf's sum of squares, as the reference's."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))
