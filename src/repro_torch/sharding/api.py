"""Logical-axis rules, and the placement of a stacked state on a mesh
(counterpart of ``repro.sharding.api``).

A ``logical_rules`` context binds logical axis names to mesh axes.  The
reference leaves the placement to XLA (``with_sharding_constraint``);
PyTorch has no partitioner, so here :func:`logical_leading` does it by
hand: it splits the leading (node) axis of a stacked ``VMState`` into one
``VMState`` a shard (``vmstate.ShardedState``), or, where the mesh does not
divide the node count, keeps one full copy on the mesh's first device
(spec ``()``), the reference's divisibility rule (``api.py:78-100``).
Outside any context it is a no-op.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core.vm import vmstate as vms


@dataclass
class LogicalRules:
    mesh: object                       # launch.mesh.NodeMesh
    # logical axis name -> mesh axis (str), tuple of mesh axes, or None
    mapping: dict = field(default_factory=dict)

    def spec_for(self, names: tuple) -> tuple:
        """The mesh axes of each logical name (None: replicated).  A mesh
        axis shards one tensor dim at most; later duplicates replicate."""
        axes = []
        used: set = set()
        for n in names:
            m = None if n is None else self.mapping.get(n)
            if m is None:
                axes.append(None)
                continue
            ms = tuple(a for a in ((m,) if isinstance(m, str) else tuple(m)) if a not in used)
            if not ms:
                axes.append(None)
            else:
                used.update(ms)
                axes.append(ms if len(ms) > 1 else ms[0])
        return tuple(axes)


_local = threading.local()


def current_rules() -> Optional[LogicalRules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: Optional[LogicalRules]):
    prev = current_rules()
    _local.rules = rules
    try:
        yield
    finally:
        _local.rules = prev


def leading_spec(n: int, name: str, rules: Optional[LogicalRules] = None) -> tuple:
    """The spec a leading axis of ``n`` rows named ``name`` gets: ``(axis,)``
    when the rules bind ``name`` and the mesh divides ``n``, else ``()``
    (replicated)."""
    rules = rules or current_rules()
    if rules is None:
        return ()
    (ax,) = rules.spec_for((name,))
    if ax is None or n % rules.mesh.size:
        return ()
    return (ax,)


def logical_leading(tree, name: str):
    """Place a stacked ``VMState`` (or one tensor) by its leading axis under
    the current rules: a ``ShardedState`` (a tensor: a tuple of per-shard
    tensors) with ``N / k`` rows a shard, each a copy of its own on its
    shard's device, when the spec is ``(axis,)``; one full copy on
    ``mesh.devices[0]`` when it is ``()``.  A no-op outside any
    ``logical_rules`` context."""
    rules = current_rules()
    if rules is None:
        return tree
    mesh = rules.mesh
    if isinstance(tree, torch.Tensor):
        n = int(tree.shape[0]) if tree.dim() else 0
        if tree.dim() == 0 or not leading_spec(n, name, rules):
            return tree.to(mesh.devices[0], copy=True)
        k = n // mesh.size
        return tuple(tree[j * k:(j + 1) * k].to(d, copy=True) for j, d in enumerate(mesh.devices))
    if isinstance(tree, vms.ShardedState):
        tree = vms.to_host(tree)
    n = int(tree.pc.shape[0])
    if leading_spec(n, name, rules):
        return vms.split_rows(tree, mesh)
    return vms.VMState(*[x.to(mesh.devices[0], copy=True) for x in tree])
