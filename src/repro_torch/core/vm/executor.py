"""Slice engines behind the VM frontends (counterpart of
``repro.core.vm.executor``).

  * :class:`TorchExecutor`        — backend ``"torch"`` of the single-node
                                    :class:`~repro_torch.core.vm.machine.REXAVM`
                                    (the reference's ``JitExecutor``): the
                                    host-canonical state is copied to the
                                    device, one batched slice runs, and the
                                    state comes back; both copies are counted;
  * :class:`OracleExecutor`       — backend ``"oracle"``: the plain-Python
                                    reference (``core/vm/oracle.py``), in
                                    place on the host state;
  * :class:`BatchedSliceExecutor` — ``executor="batched"`` of the fleet: the
                                    batched interpreter over the stacked state;
  * :class:`CudaSliceExecutor`    — ``executor="cuda"`` of the fleet (the
                                    reference's ``PallasSliceExecutor``):
                                    schedule, the vmloop kernel over every
                                    node, each declined word in the
                                    interpreter and the kernel resumed after
                                    it, preempt;
  * :class:`OracleFleetExecutor`  — ``executor="oracle"`` of the fleet: every
                                    node's slice through the Oracle on the
                                    host, slow by construction.

All update a stacked (or single) state in place and are byte-exact with
each other and with the JAX reference.  The three fleet engines also run
the Executive's micro-slice (``schedule_prio -> vmloop -> preempt`` at a
budget of the quantum, with ``switched``/``preempted`` per node):
``run_slice_exec_batched`` on the batched and Oracle engines,
``run_slice_exec_batched_aux`` on the kernel's.  For the telemetry plane each
fleet engine also offers ``obs_schedule(S) -> found`` and
``obs_execute(S, steps, found) -> ExecAux``: the same slice split at the
schedule/execute seam, counting every retired instruction in its bin
(``repro_torch.obs.metrics``).

The batched and cuda engines take ``elide_checks``: the checks-elided
interpreter (``Interpreter(elide_checks=True)``) and vmloop instance, for
fleets whose programs the static verifier admitted
(``FleetVM(executor="auto")``).  Their counting engines stay checked, as
the reference's: an elided fleet with obs counts through the checked
interpreter and the kernel's counting instance.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.interp import interp_for
from repro_torch.core.vm.spec import ISA, ST_IOWAIT, ST_RUN, ST_YIELD
from repro_torch.core.vm.vmstate import VMState, resolve_device

I32 = torch.int32


def _iowait(S) -> torch.Tensor:
    return (S.tstatus == ST_IOWAIT).sum()


class BatchedSliceExecutor:
    """``run_slice_batched(S, steps) -> found``: schedule -> vmloop ->
    preempt per node, all on the batched interpreter."""

    backend = "batched"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, elide_checks: bool = False):
        self.cfg = cfg
        self.interp = interp_for(cfg, isa, elide_checks)
        self._checked = interp_for(cfg, isa)

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        return self.interp.run_slice(S, steps)

    def run_slice_exec_batched(self, S, quantum: int):
        """The Executive micro-slice (``Interpreter.run_slice_exec``):
        ``(found, switched, preempted)``, each (N,)."""
        return self.interp.run_slice_exec(S, quantum)

    # -- observability: obs_schedule then obs_execute is run_slice_batched,
    # -- with every retired instruction binned ---------------------------------

    def obs_schedule(self, S) -> torch.Tensor:
        return self.interp.schedule(S)

    def obs_execute(self, S, steps: int, found):
        from repro_torch.obs.metrics import make_counting_finish, zero_exec_aux

        iow0 = _iowait(S)
        hist = make_counting_finish(self._checked)(S, steps, active=found)
        return zero_exec_aux(self.interp.isa, S.pc.device)._replace(
            op_hist=hist.sum(0, dtype=I32), io_susp=(_iowait(S) - iow0).to(I32))


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

    With observability (``obs_execute``) every pass launches the kernel's
    counting instance, whose per-row histograms are added back into node
    order, and the interpreter bins the declined instructions it runs; the
    sum equals the batched executor's histogram exactly.

    ``mark(layer)``, when given, is called after each layer: "schedule",
    "kernel" (each launch), "tail" (each interpreter step), "preempt".

    ``run_slice_exec_batched_aux(S, quantum, mark=None)`` is the
    Executive's micro-slice on the same passes: ``schedule_prio`` (marked
    "schedule_prio") in place of ``schedule``, a budget of ``quantum``, and
    ``preempted`` read before the preempt.

    ``elide_checks=True`` launches the kernel's checks-elided instance and
    hands declined words to the checks-elided interpreter; the counting
    path (``obs_execute``) stays checked.
    """

    backend = "cuda"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, elide_checks: bool = False):
        self.cfg = cfg
        self.isa = isa
        self.elide_checks = elide_checks
        self.interp = interp_for(cfg, isa, elide_checks)
        self._checked = interp_for(cfg, isa)

    def _execute(self, S, steps: int, mark, node_hist=None):
        """Kernel passes and hand-backs on a scheduled state; the caller
        preempts.  ``node_hist`` ((N, num_ops + 4) int32), when given, accumulates each
        node's retired instructions by bin.  Returns ``(n_exec, ever,
        met)`` as ``run_slice_batched_aux``'s last three."""
        from repro_torch.kernels.vmloop.ops import fleet_vmloop

        obs = node_hist is not None
        elide = self.elide_checks and not obs
        it = self._checked if obs else self.interp
        N, nops = S.pc.shape[0], it.num_ops
        dev = S.pc.device
        S, n_exec, bailed, bail_op, *h = fleet_vmloop(S, steps, self.cfg, self.isa, obs=obs,
                                                      elide_checks=elide)
        if obs:
            node_hist += h[0]
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
            retired += it.vmloop(S, 1, active=pending, hist=node_hist)[0]
            mark("tail")
            S, n_r, bailed, bail_op, *h = fleet_vmloop(
                S, steps, self.cfg, self.isa,
                rows=rows.to(I32), budget=steps - retired[rows], obs=obs, elide_checks=elide,
            )
            if obs:
                node_hist.index_add_(0, rows, h[0])
            mark("kernel")
            n_exec.index_add_(0, rows, n_r)
            retired.index_add_(0, rows, n_r)
            ever[rows] = ever[rows] | (bailed != 0)
        return n_exec, ever.to(I32), met.view(N, nops + 1).sum(dim=0)

    def _slice(self, S, steps: int, mark, executive: bool):
        """One slice: schedule, ``_execute``'s passes, preempt.  The
        Executive's micro-slice schedules by priority and also returns
        ``switched`` and ``preempted`` (read before the preempt)."""
        mark = mark or (lambda layer: None)
        if executive:
            prev = S.cur.clone()
            found = self.interp.schedule_prio(S)
            head = (found, (found & (S.cur != prev)).to(I32))
            mark("schedule_prio")
        else:
            found = self.interp.schedule(S)
            head = (found,)
            mark("schedule")
        out = self._execute(S, steps, mark)
        if executive:
            head += (self.interp.running_cur(S),)
        self.interp.preempt(S)
        mark("preempt")
        return (*head, *out)

    def run_slice_batched_aux(self, S, steps: int, mark=None):
        return self._slice(S, steps, mark, executive=False)

    def run_slice_exec_batched_aux(self, S, quantum: int, mark=None):
        """``(found, switched, preempted, n_exec, bailed, hist)``: the
        Executive micro-slice's counters (as ``Interpreter.run_slice_exec``)
        and the kernel's (as ``run_slice_batched_aux``)."""
        return self._slice(S, quantum, mark, executive=True)

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        return self.run_slice_batched_aux(S, steps)[0]

    # -- observability -----------------------------------------------------------

    def obs_schedule(self, S) -> torch.Tensor:
        return self.interp.schedule(S)

    def obs_execute(self, S, steps: int, found, mark=None):
        """The kernel's counting instance on every pass (rows added back to
        node order), the hand-backs binned by the interpreter; ``deopts``
        and ``bailed`` are the bailed node-rounds, ``bail_hist`` the
        node-rounds that met each declined word (``kernel_stats``)."""
        from repro_torch.obs.metrics import ExecAux, n_bins

        N = S.pc.shape[0]
        node_hist = torch.zeros(N, n_bins(self.interp.isa), dtype=I32, device=S.pc.device)
        iow0 = _iowait(S)
        mark = mark or (lambda layer: None)
        n_exec, ever, met = self._execute(S, steps, mark, node_hist)
        self.interp.preempt(S)
        mark("preempt")
        bailed = ever.sum(dtype=I32)
        return ExecAux(
            op_hist=node_hist.sum(0, dtype=I32), io_susp=(_iowait(S) - iow0).to(I32),
            deopts=bailed, kernel_steps=n_exec.sum(dtype=I32), bailed=bailed,
            bail_hist=met.to(I32),
        )


class OracleFleetExecutor:
    """The fleet's slice through the plain-Python Oracle
    (``FleetVM(executor="oracle")``): each round copies the stacked state to
    the host, runs every node's micro-slice through the Oracle in place on
    numpy views of the host copy, and copies it back.  Slow by
    construction, but it makes the operational specification a fleet
    executor whose ``metrics()`` compare with the others'.  The clock,
    routing and warp stay on the fleet's device."""

    backend = "oracle"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None):
        from repro_torch.core.vm.oracle import Oracle

        self.cfg = cfg
        self.oracle = Oracle(cfg, isa)
        self.interp = interp_for(cfg, isa)

    def _each_node(self, S, fn) -> np.ndarray:
        """``fn(node_state)`` for every node, on numpy views of one host
        copy of ``S``, which is then written back; returns the results."""
        host = [x.cpu().numpy() for x in S]        # views of S itself on the CPU
        N = host[0].shape[0]
        out = [fn(VMState(*[a[i, ...] for a in host])) for i in range(N)]
        if S.pc.device.type != "cpu":
            for x, a in zip(S, host):
                x.copy_(torch.from_numpy(a))
        return np.asarray(out)

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        found = self._each_node(S, lambda st: self.oracle.run_slice(st, steps)[1])
        return torch.as_tensor(found, device=S.pc.device)

    def run_slice_exec_batched(self, S, quantum: int):
        """The Executive micro-slice through the Oracle:
        ``(found, switched, preempted)``, each (N,)."""
        out = self._each_node(S, lambda st: self.oracle.run_slice_exec(st, quantum)[1:])
        dev = S.pc.device
        return (torch.as_tensor(out[:, 0] != 0, device=dev),
                *(torch.as_tensor(out[:, k].astype(np.int32), device=dev) for k in (1, 2)))

    # -- observability -----------------------------------------------------------

    def obs_schedule(self, S) -> torch.Tensor:
        found = self._each_node(S, lambda st: self.oracle.schedule(st)[1])
        return torch.as_tensor(found, device=S.pc.device)

    def obs_execute(self, S, steps: int, found):
        """Each node's vmloop (a node the scheduler did not wake is not
        ST_RUN and runs nothing) and preempt, binned by ``classify_host``
        through the Oracle's ``step_hook``."""
        from repro_torch.obs.metrics import classify_host, n_bins, zero_exec_aux

        oracle = self.oracle
        num_ops = oracle.num_ops
        hist = np.zeros(n_bins(oracle.isa), np.int64)
        iow = [0, 0]

        def hook(pc_ok, instr):
            hist[classify_host(pc_ok, instr, num_ops)] += 1

        def node(st):
            iow[0] += int((st.tstatus == ST_IOWAIT).sum())
            oracle.vmloop(st, steps)
            if int(st.tstatus[int(st.cur)]) == ST_RUN:
                st.tstatus[int(st.cur)] = ST_YIELD
            iow[1] += int((st.tstatus == ST_IOWAIT).sum())

        oracle.step_hook = hook
        try:
            self._each_node(S, node)
        finally:
            oracle.step_hook = None
        dev = S.pc.device
        return zero_exec_aux(oracle.isa, dev)._replace(
            op_hist=torch.as_tensor(hist.astype(np.int32), device=dev),
            io_susp=torch.tensor(iow[1] - iow[0], dtype=I32, device=dev))


class TorchExecutor:
    """One node's slice on ``device`` behind the host<->device copy
    boundary: the host-canonical single state (CPU tensors) is copied to
    the device as a one-node stack, one slice runs, and the state is copied
    back so the host can service FIOS suspensions.  ``h2d``/``d2h`` count
    the copies.  ``device=None`` is CUDA (raising without it).

    With ``obs`` the slices are counted: ``op_hist`` (numpy (num_ops + 4,)
    int64) accumulates the retired instructions by bin."""

    backend = "torch"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, device=None, obs=None):
        from repro_torch.obs.metrics import make_counting_slice, n_bins, normalize_obs

        self.cfg = cfg
        self.device = resolve_device(device)
        self.interp = interp_for(cfg, isa)
        self.obs = normalize_obs(obs)
        self.op_hist = None
        self._slice_obs = None
        if self.obs is not None:
            self.op_hist = np.zeros(n_bins(self.interp.isa), np.int64)
            self._slice_obs = make_counting_slice(self.interp)
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
        if self._slice_obs is not None:
            self.op_hist += self._slice_obs(S, steps)[1].sum(0).cpu().numpy()
        else:
            self.interp.run_slice(S, steps)
        out = vms.unstack(vms.to_host(S), 0)
        self.d2h += 1
        self.d2h_bytes += nbytes
        return out


class OracleExecutor:
    """The plain-Python reference behind ``REXAVM(backend="oracle")``: the
    Oracle runs in place on the host state (no device, no transfers).  With
    ``obs``, ``op_hist`` counts as ``TorchExecutor``'s does."""

    backend = "oracle"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, obs=None):
        from repro_torch.core.vm.oracle import Oracle
        from repro_torch.obs.metrics import n_bins, normalize_obs

        self.cfg = cfg
        self.oracle = Oracle(cfg, isa)
        self.obs = normalize_obs(obs)
        self.op_hist = None
        if self.obs is not None:
            self.op_hist = np.zeros(n_bins(self.oracle.isa), np.int64)
        self.h2d = 0
        self.d2h = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def run_slice(self, state, steps: int):
        if self.op_hist is None:
            return self.oracle.run_slice(state, steps)[0]
        from repro_torch.obs.metrics import classify_host

        num_ops = self.oracle.num_ops

        def hook(pc_ok, instr):
            self.op_hist[classify_host(pc_ok, instr, num_ops)] += 1

        self.oracle.step_hook = hook
        try:
            return self.oracle.run_slice(state, steps)[0]
        finally:
            self.oracle.step_hook = None


# The single-node backends of REXAVM(backend=...).
VM_BACKENDS = ("torch", "oracle")


def make_executor(backend: str, cfg: VMConfig, isa: ISA | None = None, device=None, obs=None):
    """A single-node slice engine.  ``device=None`` is CUDA and raises
    without it (the Oracle runs on the host, but resolves the device all the
    same); ``obs`` (None | bool | ObsConfig) turns on ``op_hist``."""
    device = resolve_device(device)
    if backend == "torch":
        return TorchExecutor(cfg, isa, device, obs=obs)
    if backend == "oracle":
        return OracleExecutor(cfg, isa, obs=obs)
    raise ValueError(
        f"unknown VM backend {backend!r}: valid backends are "
        + ", ".join(repr(b) for b in VM_BACKENDS)
    )


def bail_word(isa: ISA, code: int) -> str:
    return isa.name[code] if 0 <= code < isa.num_ops else "fios/trap"


def bail_hist_dict(isa: ISA, hist: np.ndarray) -> dict[str, int]:
    out: dict[str, int] = {}
    for code in np.flatnonzero(hist):
        w = bail_word(isa, int(code))
        out[w] = out.get(w, 0) + int(hist[code])
    return out
