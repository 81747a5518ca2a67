"""Named walks over parameter trees (the part of the reference's
``repro.utils.tree`` that quantization and checkpointing need).  A tree is
nested dicts, lists, tuples and NamedTuples with tensor leaves; a leaf's
name joins its keys, list indices and NamedTuple field names with "/"
(e.g. ``layers/0/attn/wq``), as the reference names them."""

from __future__ import annotations

from typing import Any, Callable


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
