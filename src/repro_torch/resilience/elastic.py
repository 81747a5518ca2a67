"""Elastic re-mesh: move a fleet's state onto another device mesh
(counterpart of ``repro.resilience.elastic``).

Checkpoints are mesh-agnostic (name -> host numpy), so re-scaling a job is
a restore onto the new mesh.  ``reshard_state`` is the live path for a
planned re-mesh: gather to the host, then place under the new mesh's
fleet rules.
"""

from __future__ import annotations

import torch

from repro_torch.core.vm import vmstate as vms


def _host(x):
    """A leaf as one host tensor: a state, a tensor, or a tuple of per-shard
    tensors (concatenated along the leading axis)."""
    if isinstance(x, (vms.VMState, vms.ShardedState)):
        return vms.to_host(x)
    if isinstance(x, (tuple, list)):
        return torch.cat([t.detach().to("cpu") for t in x])
    return x.detach().to("cpu", copy=True)


def reshard_state(tree, mesh, name: str = "node"):
    """Move a fleet state (a stacked ``VMState`` or a ``ShardedState``), or
    a dict of tensors keyed by name, onto ``mesh`` through the host: each
    leaf's leading axis is split over the mesh (``logical_leading`` under
    ``make_fleet_rules(mesh)``; a tensor becomes a tuple of per-shard
    tensors), or kept whole on ``mesh.devices[0]`` where the mesh does not
    divide it."""
    from repro_torch.sharding import logical_leading, logical_rules, make_fleet_rules

    with logical_rules(make_fleet_rules(mesh)):
        if isinstance(tree, dict):
            return {k: logical_leading(_host(v), name) for k, v in tree.items()}
        return logical_leading(_host(tree), name)
