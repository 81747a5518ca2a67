"""Sharding of the port (counterpart of ``repro.sharding``): logical-axis
rules and ``logical()`` for the models on a ``DeviceMesh`` (parameter,
batch and KV-cache specs: ``rules``, ``cache_specs``; kernel call sites on
local shards: ``local``), and the node-axis placement of the VM fleet's
stacked ``VMState`` on a ``NodeMesh``."""

from repro_torch.sharding.api import (
    LogicalRules,
    current_rules,
    leading_spec,
    logical,
    logical_leading,
    logical_rules,
)
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    batch_pspec,
    make_fleet_rules,
    make_rules,
    param_partition_spec,
    param_pspec_tree,
)

__all__ = [
    "logical", "logical_rules", "current_rules", "LogicalRules", "DEFAULT_RULES", "make_rules",
    "param_partition_spec", "param_pspec_tree", "batch_pspec", "leading_spec", "logical_leading",
    "make_fleet_rules",
]
