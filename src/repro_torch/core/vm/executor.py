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
                                    node, each declined word in the
                                    interpreter and the kernel resumed after
                                    it, preempt.

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
    """The vmloop kernel, handing each declined word to the interpreter.

    ``run_slice_batched_aux(S, steps, mark=None)`` runs, per node: the
    scheduler (batched, in torch); the kernel over every node; then, while
    some node bailed with budget left, that node's declined instruction in
    the batched interpreter (one instruction, no claim mask) and the kernel
    again over those rows, each with ``steps`` less what it has retired in
    kernel and interpreter; then preemption.

    It returns ``(found, n_exec, bailed, hist)``: per node the kernel's
    instructions summed over all passes and whether the node bailed at all
    ((N,) int32), and per opcode the nodes that met it at least once as a
    declined word ((num_ops + 1,) int64, index num_ops for FIOS/trap).

    Byte-exact with the batched executor: the kernel stops *before* the
    declined instruction and the interpreter executes exactly that one, so
    each node runs the same instructions in the same order.  Each pass
    retires at least one instruction a row, so there are at most ``steps``
    passes, and the interpreter runs only declined instructions.  Nodes the
    scheduler left asleep never satisfy the loops' ST_RUN condition.  The
    host syncs once a pass to pick the rows, and once in the interpreter's
    step.

    ``mark(layer)``, when given, is called after each layer: "schedule",
    "kernel" (each launch), "tail" (each interpreter step), "preempt".
    """

    backend = "cuda"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None):
        self.cfg = cfg
        self.isa = isa
        self.interp = interp_for(cfg, isa)

    def run_slice_batched_aux(self, S, steps: int, mark=None):
        from repro_torch.kernels.vmloop.ops import fleet_vmloop

        it = self.interp
        mark = mark or (lambda layer: None)
        N, nops = S.pc.shape[0], it.num_ops
        dev = S.pc.device
        found = it.schedule(S)
        mark("schedule")
        S, n_exec, bailed, bail_op = fleet_vmloop(S, steps, self.cfg, self.isa)
        mark("kernel")
        rows = torch.arange(N, device=dev)
        retired = n_exec.clone()
        ever = bailed != 0
        met = torch.zeros(N * (nops + 1), dtype=torch.bool, device=dev)
        while True:
            hit = bailed != 0
            cell = rows * (nops + 1) + torch.clamp(bail_op, 0, nops).long()
            met[cell] = met[cell] | hit
            pending = torch.zeros(N, dtype=torch.bool, device=dev)
            pending[rows] = hit & (retired[rows] < steps)
            rows = pending.nonzero().flatten()          # the pass's one sync
            if rows.numel() == 0:
                break
            retired += it.vmloop(S, 1, active=pending)[0]
            mark("tail")
            S, n_r, bailed, bail_op = fleet_vmloop(
                S, steps, self.cfg, self.isa,
                rows=rows.to(torch.int32), budget=steps - retired[rows],
            )
            mark("kernel")
            n_exec.index_add_(0, rows, n_r)
            retired.index_add_(0, rows, n_r)
            ever[rows] = ever[rows] | (bailed != 0)
        it.preempt(S)
        mark("preempt")
        return found, n_exec, ever.to(torch.int32), met.view(N, nops + 1).sum(dim=0)

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
