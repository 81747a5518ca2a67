"""Public vmloop op over a stacked ``VMState`` (counterpart of the
reference's ``repro.kernels.vmloop.ops``).

Sharding: when the fleet's node axis is split over a ``NodeMesh``
(``vmstate.ShardedState``), the kernel sees only one shard's rows at a
time.  ``fleet_vmloop(..., mesh=)`` launches it once a shard, on that
shard's device and its current stream, which is what the reference's
``shard_map`` over the mesh's node axis does.  A replicated fleet (one
stacked state on the mesh's first device) takes the direct path.
"""

from __future__ import annotations

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.spec import ISA
from repro_torch.kernels.vmloop.ref import core_of, merge_core, vmloop_ref
from repro_torch.kernels.vmloop.vmloop import vmloop_call


def _part(x, j: int, lo: int, n: int):
    """Shard ``j``'s share of ``rows``/``budget``: an entry of a per-shard
    sequence, or a global (N,) budget's slice ``lo:lo + n``."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return x[j]
    return x[lo:lo + n]


def fleet_vmloop(S, steps: int, cfg: VMConfig, isa: ISA | None = None, rows=None, budget=None,
                 obs: bool = False, elide_checks: bool = False, mesh=None):
    """Advance the nodes of a stacked state by in-kernel instructions
    (bailing per node on declined opcodes), in place: every node up to
    ``steps``, or only nodes ``rows``, each up to its ``budget`` (see
    ``vmloop_call``).  Returns ``(S, n_exec, bailed, bail_op)``, each of the
    last three (R,) int32 (R = N without ``rows``), and with ``obs=True``
    the counting instance's ``op_hist`` (R, num_ops + 4) int32 in row order;
    ``elide_checks=True`` runs the checks-elided instance.  Fields outside
    the CoreState pass through.

    A ``ShardedState`` needs its ``mesh``: the kernel is launched once a
    shard, under that shard's device.  ``rows`` is then a sequence of
    per-shard local row lists (None: every row of that shard), ``budget`` a
    sequence of per-shard budgets or, without ``rows``, one (N,) budget in
    global node order, which is split at the shard boundaries; each output
    is a tuple of per-shard tensors in mesh order."""
    if isinstance(S, vms.ShardedState):
        if mesh is None or S.mesh != mesh:
            raise ValueError("fleet_vmloop: a sharded state needs the mesh it is sharded over")
        if rows is not None and not isinstance(rows, (tuple, list)):
            raise ValueError("fleet_vmloop: rows of a sharded state are one list a shard")
        outs = []
        for j, (sh, lo) in enumerate(vms.each_shard(S)):
            b = _part(budget, j, lo, S.sizes[j])
            b = b if b is None else b.to(sh.pc.device)
            outs.append(fleet_vmloop(sh, steps, cfg, isa, rows=_part(rows, j, lo, S.sizes[j]),
                                     budget=b, obs=obs, elide_checks=elide_checks)[1:])
        return (S, *zip(*outs))
    core, *out = vmloop_call(core_of(S), steps, cfg, isa, rows=rows, budget=budget, obs=obs,
                             elide_checks=elide_checks)
    return (merge_core(S, core), *out)


__all__ = ["fleet_vmloop", "vmloop_ref"]
