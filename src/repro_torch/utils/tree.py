"""Named walks over parameter trees (the part of the reference's
``repro.utils.tree`` that quantization needs).  A tree is nested dicts and
lists with tensor leaves; a leaf's name joins its keys and list indices
with "/" (e.g. ``layers/0/attn/wq``)."""

from __future__ import annotations

from typing import Any, Callable


def tree_flatten_with_names(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten a tree into (slash/separated/name, leaf) pairs, in order."""
    if isinstance(tree, dict):
        items = tree.items()
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
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_names(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
