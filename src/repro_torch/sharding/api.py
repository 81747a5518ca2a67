"""Logical-axis rules, and the placement of tensors on a mesh
(counterpart of ``repro.sharding.api``).

A ``logical_rules`` context binds logical axis names to mesh axes; model
code annotates activations with logical names (``logical(x, "batch",
"seq", "embed")``).  The reference leaves the placement to XLA
(``with_sharding_constraint``).  Here:

  * on a ``DeviceMesh`` (the models), :func:`logical` redistributes a
    DTensor to the placements its spec gives;
  * on a ``NodeMesh`` (the VM fleet), :func:`logical_leading` splits the
    leading (node) axis of a stacked ``VMState`` into one ``VMState`` a
    shard (``vmstate.ShardedState``), or keeps one full copy on the mesh's
    first device (spec ``()``).

Both apply the reference's divisibility rule (``api.py:78-100``): a dim
that its mesh axes do not divide is replicated.  Outside any context, or
on a plain tensor, both are no-ops.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.vm import vmstate as vms


@dataclass
class LogicalRules:
    mesh: object                       # a DeviceMesh, or a launch.mesh.NodeMesh
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


class _Current:
    """The active rules, for the whole process rather than a thread: the
    autograd engine runs a CUDA backward, and in it each checkpointed
    layer's recompute, on a thread of its own, which must see them."""

    rules: Optional[LogicalRules] = None


_current = _Current()


def current_rules() -> Optional[LogicalRules]:
    return _current.rules


@contextlib.contextmanager
def logical_rules(rules: Optional[LogicalRules]):
    prev = current_rules()
    _current.rules = rules
    try:
        yield
    finally:
        _current.rules = prev


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


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------

def axis_sizes(mesh: DeviceMesh) -> dict:
    """Mesh axis name -> its size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(ax) -> tuple:
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def fit_spec(shape, spec, sizes: dict) -> tuple:
    """``spec`` padded to ``len(shape)`` with each dim its mesh axes do not
    divide replicated (the reference's divisibility rule).  An axis of size
    1, or one the mesh lacks (see :func:`compute_mesh`), shards nothing and
    is dropped."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, spec):
        axes = tuple(a for a in _axes(ax) if sizes.get(a, 1) > 1)
        n = int(np.prod([sizes[a] for a in axes]))
        out.append(None if not axes or dim % n else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def compute_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh DTensors are placed on: ``mesh`` without its size-1 axes
    when it has more than two (a size-1 axis shards nothing, and DTensor's
    sharding propagation over three mesh dims is too slow to run a model).
    Specs naming a dropped axis lose it (``fit_spec``, ``placements``)."""
    if mesh.ndim <= 2:
        return mesh
    keep = tuple(n for n, k in zip(mesh.mesh_dim_names, mesh.shape) if k > 1)
    if len(keep) == mesh.ndim:
        return mesh
    return mesh[keep or mesh.mesh_dim_names[-1:]]


def placements(names, spec) -> tuple:
    """DTensor placements (one per mesh dim) of a spec over a mesh with
    axis ``names`` (a ``DeviceMesh``'s ``mesh_dim_names``, or a
    ``MeshConfig``'s ``axis_names``): ``Shard(d)`` on each mesh axis that
    names tensor dim d, ``Replicate()`` elsewhere; axes not in ``names``
    are skipped.  A dim on several axes is split over them outer to inner
    in mesh order, as a JAX ``PartitionSpec`` tuple is."""
    names = tuple(names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in _axes(ax):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape, spec, sizes: dict) -> tuple:
    """The shape of one shard of a tensor of ``shape`` under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // int(np.prod([sizes.get(a, 1) for a in _axes(ax)]))
                 for d, ax in zip(shape, spec))


def shard_of(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``spec`` (a fitted
    spec; see :func:`fit_spec`), a copy of its own."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, ax in enumerate(spec):
        axes = _axes(ax)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:                     # outer to inner
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        step = x.shape[d] // n
        x = x.narrow(d, idx * step, step)
    return x.clone(memory_format=torch.contiguous_format)


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def distribute(x: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """A DTensor of ``x`` (the same full tensor on every rank) placed by
    ``spec``: each rank keeps a copy of its own shard and nothing else.
    No communication."""
    spec = fit_spec(x.shape, spec, axis_sizes(mesh))
    return DTensor.from_local(shard_of(x, mesh, spec), mesh, placements(mesh.mesh_dim_names, spec),
                              run_check=False, shape=x.shape,
                              stride=_contiguous_strides(x.shape))


def logical(x, *names):
    """Place ``x`` by logical axis names under the current rules: on a
    DTensor over a ``DeviceMesh``, redistribute it to the placements of
    its spec (a dim the mesh axes do not divide, such as whisper's 6 heads
    on a 16-way axis, is replicated).  A no-op outside any rules, on a
    plain tensor, or under fleet rules."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor) or not isinstance(rules.mesh, DeviceMesh):
        return x
    if len(names) != x.ndim:
        raise ValueError(f"logical: {len(names)} names for a {x.ndim}-d tensor {tuple(x.shape)}")
    spec = fit_spec(x.shape, rules.spec_for(names), axis_sizes(rules.mesh))
    want = placements(rules.mesh.mesh_dim_names, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)
