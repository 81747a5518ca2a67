"""Sharding rules for the VM fleet (counterpart of the fleet's part of
``repro.sharding.rules``; the parameter and activation rules of the
models come with the model-sharding slice)."""

from __future__ import annotations

from repro_torch.sharding.api import LogicalRules


def make_fleet_rules(mesh, node_axis: str = "node") -> LogicalRules:
    """Rules for the VM fleet: the logical ``"node"`` axis (the leading
    axis of a stacked ``VMState``) binds to the mesh's node axis, and
    everything else stays node-local.  ``logical_leading``'s divisibility
    rule makes a fleet the mesh does not divide replicate, so the same
    engines serve one shard and many."""
    if node_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {node_axis!r} axis")
    return LogicalRules(mesh=mesh, mapping={"node": node_axis})
