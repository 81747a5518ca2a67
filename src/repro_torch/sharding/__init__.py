"""Node-axis sharding of the VM fleet (counterpart of the fleet's part of
``repro.sharding``): logical rules over a ``NodeMesh`` and the placement
of a stacked ``VMState`` on it.  The model-side rules (parameter and
KV-cache specs) come with the model-sharding slice."""

from repro_torch.sharding.api import (
    LogicalRules,
    current_rules,
    leading_spec,
    logical_leading,
    logical_rules,
)
from repro_torch.sharding.rules import make_fleet_rules

__all__ = [
    "LogicalRules", "current_rules", "leading_spec", "logical_leading", "logical_rules",
    "make_fleet_rules",
]
