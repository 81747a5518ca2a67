"""Small helpers shared across the port."""
from repro_torch.utils.timing import Timer, timed
from repro_torch.utils.tree import (
    tree_flatten_with_names,
    tree_map_with_names,
    tree_num_params,
    tree_size_bytes,
)

__all__ = [
    "tree_size_bytes",
    "tree_num_params",
    "tree_flatten_with_names",
    "tree_map_with_names",
    "Timer",
    "timed",
]
