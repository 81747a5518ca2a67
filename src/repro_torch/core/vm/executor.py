"""Slice engines behind the VM frontends (counterpart of
``repro.core.vm.executor``).

  * :class:`TorchExecutor`        — backend ``"torch"`` of the single-node
                                    :class:`~repro_torch.core.vm.machine.REXAVM`
                                    (the reference's ``JitExecutor``): the
                                    host-canonical state is copied to the
                                    device, one batched slice runs, and the
                                    state comes back; both copies are counted;
  * :class:`BatchedSliceExecutor` — ``executor="batched"`` of the fleet: the
                                    batched interpreter over the stacked state;
  * :class:`CudaSliceExecutor`    — ``executor="cuda"`` of the fleet (the
                                    reference's ``PallasSliceExecutor``):
                                    schedule, the vmloop kernel over every
                                    node, the interpreter as the tail over the
                                    nodes that bailed, preempt.

All update a stacked state in place and are byte-exact with each other and
with the JAX reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.interp import interp_for
from repro_torch.core.vm.spec import ISA


class BatchedSliceExecutor:
    """``run_slice_batched(S, steps) -> found``: schedule -> vmloop ->
    preempt per node, all on the batched interpreter."""

    backend = "batched"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None):
        self.cfg = cfg
        self.interp = interp_for(cfg, isa)

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        return self.interp.run_slice(S, steps)


class CudaSliceExecutor:
    """The vmloop kernel plus the interpreter tail.

    ``run_slice_batched_aux(S, steps)`` runs, per node: the scheduler
    (batched, in torch), the kernel over every node, the interpreter tail
    over the nodes that bailed before a declined word (with the budget the
    kernel left them), and preemption.  It returns ``(found, n_exec,
    bailed, bail_op)``.  Byte-exact with the batched executor: the kernel
    stops *before* the declined instruction, so the tail resumes from the
    same state.  Nodes the scheduler left asleep never satisfy the loops'
    ST_RUN condition.

    Choosing the tail's rows costs one small device-to-host read per slice
    (the indices of the bailed nodes).
    """

    backend = "cuda"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None):
        self.cfg = cfg
        self.isa = isa
        self.interp = interp_for(cfg, isa)

    def run_slice_batched_aux(self, S, steps: int):
        from repro_torch.kernels.vmloop.ops import fleet_vmloop

        it = self.interp
        found = it.schedule(S)
        S, n_exec, bailed, bail_op = fleet_vmloop(S, steps, self.cfg, self.isa)
        tail = bailed != 0
        if bool(tail.any()):
            it.vmloop(S, steps, active=tail, budget=steps - n_exec)
        it.preempt(S)
        return found, n_exec, bailed, bail_op

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        return self.run_slice_batched_aux(S, steps)[0]


class TorchExecutor:
    """One node's slice on ``device`` behind the host<->device copy
    boundary: the host-canonical single state (CPU tensors) is copied to
    the device as a one-node stack, one slice runs, and the state is copied
    back so the host can service FIOS suspensions.  ``h2d``/``d2h`` count
    the copies."""

    backend = "torch"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.interp = interp_for(cfg, isa)
        self.h2d = 0
        self.d2h = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def run_slice(self, state, steps: int):
        nbytes = vms.state_nbytes(state)
        S = vms.stack1(vms.to_device(state, self.device))
        if S.cs.data_ptr() == state.cs.data_ptr():
            S = vms.clone(S)
        self.h2d += 1
        self.h2d_bytes += nbytes
        self.interp.run_slice(S, steps)
        out = vms.unstack(vms.to_host(S), 0)
        self.d2h += 1
        self.d2h_bytes += nbytes
        return out


def make_executor(backend: str, cfg: VMConfig, isa: ISA | None = None, device="cpu"):
    if backend == "torch":
        return TorchExecutor(cfg, isa, device)
    raise ValueError(f"unknown VM backend {backend!r}: valid backends are 'torch'")


def bail_word(isa: ISA, code: int) -> str:
    return isa.name[code] if 0 <= code < isa.num_ops else "fios/trap"


def bail_hist_dict(isa: ISA, hist: np.ndarray) -> dict[str, int]:
    out: dict[str, int] = {}
    for code in np.flatnonzero(hist):
        w = bail_word(isa, int(code))
        out[w] = out.get(w, 0) + int(hist[code])
    return out
