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
  * ``"cuda"`` and ``"trace"``      — the single-node backends over the two
                                    engines below (``CudaSliceExecutor.
                                    run_slice``, ``TraceJitExecutor.
                                    run_slice``), copied as ``"torch"``;
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
                                    host, slow by construction;
  * ``TraceJitExecutor``           — ``executor="trace"`` (``core/vm/trace.
                                    py``): nodes grouped by program, each
                                    group's recorded path replayed as
                                    guarded specialized steps, then
                                    ``CudaSliceExecutor``'s kernel passes as
                                    the tail at each node's remaining budget.

All update a stacked (or single) state in place and are byte-exact with
each other and with the JAX reference.  The four fleet engines also run
the Executive's micro-slice (``schedule_prio -> vmloop -> preempt`` at a
budget of the quantum, with ``switched``/``preempted`` per node):
``run_slice_exec_batched`` on the batched, Oracle and trace engines,
``run_slice_exec_batched_aux`` on the kernel's.  For the telemetry plane each
fleet engine also offers ``obs_schedule(S) -> found`` and
``obs_execute(S, steps, found) -> ExecAux``: the same slice split at the
schedule/execute seam, counting every retired instruction in its bin
(``repro_torch.obs.metrics``).

Node sharding: the batched, cuda and Oracle engines take ``mesh=`` (a
``NodeMesh``) and then also run a ``vmstate.ShardedState``: each shard's
slice runs on its own device (``vmstate.each_shard``), the kernel launched
once a shard (``fleet_vmloop(..., mesh=)``), and the per-node outputs are
joined in node order on the first shard's device.  A plain stacked state
(a replicated fleet) takes the meshless path.

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


def _per_shard(S, fn, mesh):
    """``fn(shard)`` on each shard of ``S`` under its device, the per-node
    outputs joined in node order on the first shard's device."""
    if isinstance(S, vms.ShardedState) and S.mesh != mesh:
        raise ValueError("the state is sharded over another mesh than the engine's")
    return vms.join_rows([fn(sh) for sh, _ in vms.each_shard(S)], vms.first_device(S))


class BatchedSliceExecutor:
    """``run_slice_batched(S, steps) -> found``: schedule -> vmloop ->
    preempt per node, all on the batched interpreter."""

    backend = "batched"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, elide_checks: bool = False,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.interp = interp_for(cfg, isa, elide_checks)
        self._checked = interp_for(cfg, isa)

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        return _per_shard(S, lambda sh: self.interp.run_slice(sh, steps), self.mesh)

    def run_slice_exec_batched(self, S, quantum: int):
        """The Executive micro-slice (``Interpreter.run_slice_exec``):
        ``(found, switched, preempted)``, each (N,)."""
        return _per_shard(S, lambda sh: self.interp.run_slice_exec(sh, quantum), self.mesh)

    # -- observability: obs_schedule then obs_execute is run_slice_batched,
    # -- with every retired instruction binned ---------------------------------

    def obs_schedule(self, S) -> torch.Tensor:
        return _per_shard(S, self.interp.schedule, self.mesh)

    def obs_execute(self, S, steps: int, found):
        from repro_torch.obs.metrics import make_counting_finish, zero_exec_aux

        finish = make_counting_finish(self._checked)
        hist, io_susp = [], []
        for sh, lo in vms.each_shard(S):
            iow0 = _iowait(sh)
            active = found[lo:lo + sh.pc.shape[0]].to(sh.pc.device)
            hist.append(finish(sh, steps, active=active).sum(0, dtype=I32))
            io_susp.append((_iowait(sh) - iow0).to(I32))
        dev = vms.first_device(S)
        return zero_exec_aux(self.interp.isa, dev)._replace(
            op_hist=vms.sum_to(hist, dev), io_susp=vms.sum_to(io_susp, dev))


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

    ``run_slice(state, steps)`` is the single-node protocol behind
    ``REXAVM(backend="cuda")`` (the reference's ``PallasSliceExecutor.
    run_slice``): the host-canonical state is copied to ``device`` as a
    one-node stack, one slice runs, and it is copied back; ``h2d``/``d2h``
    and their bytes count the copies, ``kernel_steps`` and
    ``fallback_steps`` the instructions retired in the kernel and in the
    interpreter, ``bailouts`` the slices that met a declined word and
    ``bail_hist`` the slices that met each one (``"fios/trap"`` for FIOS
    calls and traps).  With ``obs`` every slice runs the counting path and
    ``op_hist`` accumulates its bins.
    """

    backend = "cuda"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, elide_checks: bool = False,
                 device=None, obs=None, mesh=None):
        from repro_torch.obs.metrics import n_bins, normalize_obs

        self.cfg = cfg
        self.isa = isa
        self.mesh = mesh
        self.elide_checks = elide_checks
        self.interp = interp_for(cfg, isa, elide_checks)
        self._checked = interp_for(cfg, isa)
        self.device = device
        self.obs = normalize_obs(obs)
        self.op_hist = None if self.obs is None else np.zeros(n_bins(self.interp.isa), np.int64)
        self.h2d = self.d2h = self.h2d_bytes = self.d2h_bytes = 0
        self.kernel_steps = 0
        self.fallback_steps = 0
        self.bailouts = 0
        self.bail_hist: dict[str, int] = {}

    def _execute(self, S, steps, mark, node_hist=None):
        """Kernel passes and hand-backs on a scheduled state; the caller
        preempts.  ``steps`` is one budget for every node (an int) or one
        per node ((N,) int32: the trace-JIT's tail, each node's slice less
        its specialized steps), which the first launch takes as ``budget``.
        ``node_hist`` ((N, num_ops + 4) int32), when given, accumulates each
        node's retired instructions by bin.  Returns ``(n_exec, ever,
        met)`` as ``run_slice_batched_aux``'s last three.

        On a sharded state the first launch goes to every shard
        (``fleet_vmloop(..., mesh=)``), and each pass runs per shard: the
        pending rows (one host sync a shard), the declined instructions,
        the relaunch over those rows.  Per-node ``steps`` and ``node_hist``
        are then tuples of per-shard tensors; the outputs are joined in node
        order on the first shard's device."""
        from repro_torch.kernels.vmloop.ops import fleet_vmloop

        obs = node_hist is not None
        elide = self.elide_checks and not obs
        it = self._checked if obs else self.interp
        nops = it.num_ops
        sharded = isinstance(S, vms.ShardedState)
        shards = vms.shards_of(S)
        k = len(shards)
        per_node = isinstance(steps, (torch.Tensor, tuple, list))
        budgets = (tuple(steps) if sharded else (steps,)) if per_node else (steps,) * k
        hists = (tuple(node_hist) if sharded else (node_hist,)) if obs else (None,) * k
        first = fleet_vmloop(
            S, 0 if per_node else steps, self.cfg, self.isa,
            budget=(budgets if sharded else steps) if per_node else None, obs=obs,
            elide_checks=elide, mesh=self.mesh if sharded else None)[1:]
        if not sharded:
            first = tuple((x,) for x in first)
        n_exec, bailed, bail_op = (list(x) for x in first[:3])
        if obs:
            for h, add in zip(hists, first[3]):
                h += add
        mark("kernel")
        rows = [torch.arange(sh.pc.shape[0], device=sh.pc.device) for sh in shards]
        retired = [x.clone() for x in n_exec]
        ever = [b != 0 for b in bailed]
        met = [torch.zeros(sh.pc.shape[0] * (nops + 1), dtype=torch.bool, device=sh.pc.device)
               for sh in shards]
        pend: list = [None] * k

        def budget_of(j, r):
            return budgets[j][r] if per_node else steps

        live = list(range(k))
        while True:
            nxt = []
            for j in live:
                sh = shards[j]
                with vms.on_device(sh.pc.device):
                    hit = bailed[j] != 0
                    cell = rows[j] * (nops + 1) + torch.clamp(bail_op[j], 0, nops).long()
                    met[j][cell] = met[j][cell] | hit
                    pending = torch.zeros(sh.pc.shape[0], dtype=torch.bool, device=sh.pc.device)
                    pending[rows[j]] = hit & (retired[j][rows[j]] < budget_of(j, rows[j]))
                    r = pending.nonzero().flatten()      # the pass's one sync a shard
                if r.numel():
                    rows[j], pend[j] = r, pending
                    nxt.append(j)
            if not nxt:
                break
            for j in nxt:
                with vms.on_device(shards[j].pc.device):
                    retired[j] += it.vmloop(shards[j], 1, active=pend[j], hist=hists[j])[0]
            mark("tail")
            for j in nxt:
                r = rows[j]
                with vms.on_device(shards[j].pc.device):
                    left = budget_of(j, r) - retired[j][r]
                    _, n_r, bailed[j], bail_op[j], *h = fleet_vmloop(
                        shards[j], 0 if per_node else steps, self.cfg, self.isa,
                        rows=r.to(I32), budget=left, obs=obs, elide_checks=elide,
                    )
                    if obs:
                        hists[j].index_add_(0, r, h[0])
                    n_exec[j].index_add_(0, r, n_r)
                    retired[j].index_add_(0, r, n_r)
                    ever[j][r] = ever[j][r] | (bailed[j] != 0)
            mark("kernel")
            live = nxt
        dev = shards[0].pc.device
        return (vms.join_rows(n_exec, dev), vms.join_rows([e.to(I32) for e in ever], dev),
                vms.sum_to([m.view(-1, nops + 1).sum(dim=0) for m in met], dev))

    def _slice(self, S, steps: int, mark, executive: bool):
        """One slice: schedule, ``_execute``'s passes, preempt.  The
        Executive's micro-slice schedules by priority and also returns
        ``switched`` and ``preempted`` (read before the preempt)."""
        mark = mark or (lambda layer: None)
        heads = []
        for sh, _ in vms.each_shard(S):
            if executive:
                prev = sh.cur.clone()
                found = self.interp.schedule_prio(sh)
                heads.append((found, (found & (sh.cur != prev)).to(I32)))
            else:
                heads.append((self.interp.schedule(sh),))
        mark("schedule_prio" if executive else "schedule")
        out = self._execute(S, steps, mark)
        for j, (sh, _) in enumerate(vms.each_shard(S)):
            if executive:
                heads[j] += (self.interp.running_cur(sh),)
            self.interp.preempt(sh)
        mark("preempt")
        return (*vms.join_rows(heads, vms.first_device(S)), *out)

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
        return _per_shard(S, self.interp.schedule, self.mesh)

    def obs_execute(self, S, steps: int, found, mark=None):
        """The kernel's counting instance on every pass (rows added back to
        node order), the hand-backs binned by the interpreter; ``deopts``
        and ``bailed`` are the bailed node-rounds, ``bail_hist`` the
        node-rounds that met each declined word (``kernel_stats``)."""
        from repro_torch.obs.metrics import ExecAux, n_bins

        shards = vms.shards_of(S)
        dev = shards[0].pc.device
        hists = tuple(torch.zeros(sh.pc.shape[0], n_bins(self.interp.isa), dtype=I32,
                                  device=sh.pc.device) for sh in shards)
        iow0 = [_iowait(sh) for sh in shards]
        mark = mark or (lambda layer: None)
        n_exec, ever, met = self._execute(
            S, steps, mark, hists if isinstance(S, vms.ShardedState) else hists[0])
        io_susp = []
        for j, (sh, _) in enumerate(vms.each_shard(S)):
            self.interp.preempt(sh)
            io_susp.append(_iowait(sh) - iow0[j])
        mark("preempt")
        bailed = ever.sum(dtype=I32)
        return ExecAux(
            op_hist=vms.sum_to([h.sum(0, dtype=I32) for h in hists], dev),
            io_susp=vms.sum_to(io_susp, dev).to(I32),
            deopts=bailed, kernel_steps=n_exec.sum(dtype=I32), bailed=bailed,
            bail_hist=met.to(I32),
        )


    # -- the single-node protocol (REXAVM(backend="cuda")) ---------------------------

    def run_slice(self, state, steps: int):
        nbytes = vms.state_nbytes(state)
        S = vms.stack1(vms.to_device(state, resolve_device(self.device)))
        if S.cs.data_ptr() == state.cs.data_ptr():
            S = vms.clone(S)
        self.h2d += 1
        self.h2d_bytes += nbytes
        if self.op_hist is not None:
            aux = self.obs_execute(S, steps, self.obs_schedule(S))
            self.op_hist += aux.op_hist.cpu().numpy()
            n_exec, bailed, hist = aux.kernel_steps, aux.bailed, aux.bail_hist
        else:
            _, n_exec, bailed, hist = self.run_slice_batched_aux(S, steps)
        out = vms.unstack(vms.to_host(S), 0)
        self.d2h += 1
        self.d2h_bytes += nbytes
        kernel = int(n_exec.sum())
        self.kernel_steps += kernel
        self.fallback_steps += int(out.steps) - int(state.steps) - kernel
        self.bailouts += int(bailed.sum())
        for word, count in bail_hist_dict(self.interp.isa, hist.cpu().numpy()).items():
            self.bail_hist[word] = self.bail_hist.get(word, 0) + count
        return out


class OracleFleetExecutor:
    """The fleet's slice through the plain-Python Oracle
    (``FleetVM(executor="oracle")``): each round copies the stacked state to
    the host, runs every node's micro-slice through the Oracle in place on
    numpy views of the host copy, and copies it back.  Slow by
    construction, but it makes the operational specification a fleet
    executor whose ``metrics()`` compare with the others'.  The clock,
    routing and warp stay on the fleet's device."""

    backend = "oracle"

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, mesh=None):
        from repro_torch.core.vm.oracle import Oracle

        self.cfg = cfg
        self.mesh = mesh
        self.oracle = Oracle(cfg, isa)
        self.interp = interp_for(cfg, isa)

    def _each_node(self, S, fn) -> np.ndarray:
        """``fn(node_state)`` for every node in node order, on numpy views of
        one host copy of each shard of ``S``, which is then written back;
        returns the results."""
        if isinstance(S, vms.ShardedState) and S.mesh != self.mesh:
            raise ValueError("the state is sharded over another mesh than the engine's")
        out = []
        for sh in vms.shards_of(S):
            host = [x.cpu().numpy() for x in sh]       # views of sh itself on the CPU
            out.extend(fn(VMState(*[a[i, ...] for a in host])) for i in range(host[0].shape[0]))
            if sh.pc.device.type != "cpu":
                for x, a in zip(sh, host):
                    x.copy_(torch.from_numpy(a))
        return np.asarray(out)

    def run_slice_batched(self, S, steps: int) -> torch.Tensor:
        found = self._each_node(S, lambda st: self.oracle.run_slice(st, steps)[1])
        return torch.as_tensor(found, device=vms.first_device(S))

    def run_slice_exec_batched(self, S, quantum: int):
        """The Executive micro-slice through the Oracle:
        ``(found, switched, preempted)``, each (N,)."""
        out = self._each_node(S, lambda st: self.oracle.run_slice_exec(st, quantum)[1:])
        dev = vms.first_device(S)
        return (torch.as_tensor(out[:, 0] != 0, device=dev),
                *(torch.as_tensor(out[:, k].astype(np.int32), device=dev) for k in (1, 2)))

    # -- observability -----------------------------------------------------------

    def obs_schedule(self, S) -> torch.Tensor:
        found = self._each_node(S, lambda st: self.oracle.schedule(st)[1])
        return torch.as_tensor(found, device=vms.first_device(S))

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
        dev = vms.first_device(S)
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
VM_BACKENDS = ("torch", "oracle", "cuda", "trace")


def make_executor(backend: str, cfg: VMConfig, isa: ISA | None = None, device=None, obs=None):
    """A single-node slice engine.  ``device=None`` is CUDA and raises
    without it (the Oracle runs on the host, but resolves the device all the
    same); ``obs`` (None | bool | ObsConfig) turns on ``op_hist``.  On a
    CPU device ``"cuda"`` (and the trace-JIT's tail) takes the vmloop
    kernel's plain version."""
    device = resolve_device(device)
    if backend == "torch":
        return TorchExecutor(cfg, isa, device, obs=obs)
    if backend == "oracle":
        return OracleExecutor(cfg, isa, obs=obs)
    if backend == "cuda":
        return CudaSliceExecutor(cfg, isa, device=device, obs=obs)
    if backend == "trace":
        from repro_torch.core.vm.trace import TraceJitExecutor

        return TraceJitExecutor(cfg, isa, device=device, obs=obs)
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
