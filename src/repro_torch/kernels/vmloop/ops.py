"""Public vmloop op over a stacked ``VMState`` (counterpart of the
reference's ``repro.kernels.vmloop.ops``; no mesh yet)."""

from __future__ import annotations

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import ISA
from repro_torch.kernels.vmloop.ref import core_of, merge_core, vmloop_ref
from repro_torch.kernels.vmloop.vmloop import vmloop_call


def fleet_vmloop(S, steps: int, cfg: VMConfig, isa: ISA | None = None, rows=None, budget=None,
                 obs: bool = False):
    """Advance the nodes of a stacked state by in-kernel instructions
    (bailing per node on declined opcodes), in place: every node up to
    ``steps``, or only nodes ``rows``, each up to its ``budget`` (see
    ``vmloop_call``).  Returns ``(S, n_exec, bailed, bail_op)``, each of the
    last three (R,) int32 (R = N without ``rows``), and with ``obs=True``
    the counting instance's ``op_hist`` (R, num_ops + 4) int32 in row order;
    fields outside the CoreState pass through."""
    core, *out = vmloop_call(core_of(S), steps, cfg, isa, rows=rows, budget=budget, obs=obs)
    return (merge_core(S, core), *out)


__all__ = ["fleet_vmloop", "vmloop_ref"]
