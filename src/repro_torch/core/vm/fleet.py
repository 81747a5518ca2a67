"""Device-resident VM fleet — N cooperating REXAVM nodes, one stacked state
(counterpart of ``repro.core.vm.fleet``).

``FleetVM`` holds N node states as ONE stacked ``VMState`` on the device.
A round is three layers, all updating that state in place:

  1. one micro-slice per node (``schedule -> vmloop -> preempt``) on the
     batched interpreter (``executor="batched"``), on the vmloop CUDA
     kernel, which hands each word it declines to the interpreter
     (``executor="cuda"``), through the plain-Python Oracle on the host
     (``executor="oracle"``), or as the trace-JIT's guarded specialized
     steps per program group with the kernel as the tail
     (``executor="trace"``, ``core/vm/trace.py``); ``executor="auto"`` lets
     the Auditor (``repro_torch.analysis``) pick batched, cuda or trace at
     ``start()``, with the stack checks elided where every program verified;
  2. the virtual clock: ``now += max(1, executed * us_per_instr // 1000)``;
  3. mailbox routing (``routing.build_router``): all sends in (node, task)
     order, then all receives;
  4. the time warp to the earliest wake-up of nodes with nothing runnable,
     no routing progress and no IO suspension.

Host IO (FIOS calls, ``out``/``in``) is found by a small per-round status
probe and serviced by :class:`~repro_torch.core.vm.ios.FleetIOService`,
which moves only the suspended nodes' rows, or by the vectorized syscall
plane (``io_mode="vector"``, :class:`~repro_torch.exec.syscalls.
VectorSyscallService`: the same movement, one handler call per distinct
syscall).  ``reference_round`` is the same round over independent
host-looped nodes.

With ``executive=`` (an :class:`~repro_torch.exec.ExecutiveConfig`) step 1
becomes ``slices`` preemptive micro-slices of ``quantum`` instructions
(``schedule_prio -> vmloop -> preempt`` each), and steps 2–4 run once a
round after them (``FleetKernels.round_exec``).

With ``obs=`` (``repro_torch.obs``) each round runs split at its phase
seams (schedule, execute, clock and router, warp) so that the fleet can
count, trace and time each phase; ``metrics()`` and ``export_trace()``
read the result.  With ``obs=None`` (the default) the round loop is the
plain one: no extra device outputs and no synchronization.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.executor import (
    BatchedSliceExecutor,
    CudaSliceExecutor,
    OracleFleetExecutor,
    bail_hist_dict,
)
from repro_torch.core.vm.ios import FleetIOService
from repro_torch.core.vm.machine import REXAVM, resolve_device
from repro_torch.core.vm.routing import build_router
from repro_torch.core.vm.spec import (
    ISA,
    ST_DONE,
    ST_ERR,
    ST_EVENT,
    ST_FREE,
    ST_HALT,
    ST_IOWAIT,
    ST_SLEEP,
    ST_YIELD,
    get_isa,
)
from repro_torch.core.vm.trace import TraceJitExecutor, program_key
from repro_torch.core.vm.vmstate import VMState

I32 = torch.int32
_I32_MAX = 2 ** 31 - 1

EXECUTORS = ("batched", "cuda", "oracle", "trace")


class FleetKernels:
    """Slice + routing + clock for one (VMConfig, ISA, executor).

    ``elide_checks=True`` (batched and cuda only) runs the slice on the
    checks-elided interpreter and vmloop instance: for fleets whose every
    program the static verifier admitted (``FleetVM(executor="auto")``).

    ``round(S, steps)`` is one fleet round; ``round_aux`` also returns the
    kernel's per-node step counts (over all its launches of the slice),
    whether each node bailed, and per opcode the nodes that met it as a
    declined word (``executor="cuda"`` only; None otherwise; ``mark`` as
    ``CudaSliceExecutor.run_slice_batched_aux``'s); ``rounds_aux(S, steps,
    n)`` runs ``n`` whole rounds and sums those.

    With an ``executive`` (``ExecutiveConfig``), ``round_exec(S, mark=None)``
    is one round under the Executive (see there)."""

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, executor: str = "batched",
                 elide_checks: bool = False, executive=None):
        self.cfg = cfg
        self.isa = isa or get_isa()
        self.executive = executive
        if elide_checks and executor not in ("batched", "cuda"):
            raise ValueError(f"executor {executor!r} has no checks-elided engine")
        if executor == "batched":
            self.executor = BatchedSliceExecutor(cfg, isa, elide_checks)
        elif executor == "cuda":
            self.executor = CudaSliceExecutor(cfg, isa, elide_checks)
        elif executor == "oracle":
            self.executor = OracleFleetExecutor(cfg, isa)
        elif executor == "trace":
            self.executor = TraceJitExecutor(cfg, isa)
        else:
            raise ValueError(
                f"unknown fleet executor {executor!r}: valid executors are "
                + ", ".join(repr(e) for e in EXECUTORS)
            )
        self.executor_kind = executor
        self.interp = self.executor.interp
        self.route = build_router(cfg, self.isa)
        self._route_obs = None
        if executor != "cuda":
            self.round_aux = None
            self.rounds_aux = None

    def clock(self, S, steps0) -> torch.Tensor:
        """Advance each node's virtual clock by its slice's instructions;
        returns the increment (N,)."""
        cfg = self.cfg
        inc = torch.clamp(torch.div((S.steps - steps0) * cfg.us_per_instr, 1000, rounding_mode="floor"), min=1)
        S.now.add_(inc)
        return inc

    def post_slice(self, S, steps0) -> None:
        self.clock(S, steps0)
        progress = self.route(S)
        self.warp(S, progress)

    # -- the observed round's phases (FleetVM._round_obs) -------------------------

    def clock_route(self, S, steps0):
        """The clock and the router's obs variant: ``(inc, drops, depth,
        progress)``.  With ``warp`` it is exactly ``post_slice``."""
        if self._route_obs is None:
            self._route_obs = build_router(self.cfg, self.isa, obs=True)
        inc = self.clock(S, steps0)
        _, progress, (drops, depth) = self._route_obs(S)
        return inc, drops, depth, progress

    @staticmethod
    def accum(acc, aux, inc, drops, depth, deadline_ms: int):
        """Fold one round's measurements into the device counters.  A node
        misses the virtual-clock deadline when its round's clock increment
        exceeds it: a function of retired instructions, so exact across
        executors."""
        from repro_torch.obs.metrics import ObsCounters

        miss = ((inc > deadline_ms) & (deadline_ms > 0)).to(torch.int32)
        return ObsCounters(
            op_retired=acc.op_retired + aux.op_hist,
            mbox_high=torch.maximum(acc.mbox_high, depth),
            mbox_drops=acc.mbox_drops + drops,
            io_susp=acc.io_susp + aux.io_susp,
            deopts=acc.deopts + aux.deopts,
            deadline_miss=acc.deadline_miss + miss,
            rounds=acc.rounds + 1,
        )

    @staticmethod
    def warp(S, progress) -> None:
        """Virtual-time warp to the earliest wake-up (REXAVM.run step 4)."""
        runnable = (S.tstatus == ST_YIELD).any(dim=1)
        iowait = (S.tstatus == ST_IOWAIT).any(dim=1)
        waiting = (S.tstatus == ST_SLEEP) | (S.tstatus == ST_EVENT)
        wake = torch.where(waiting, S.timeout, _I32_MAX).amin(dim=1)
        warp = ~runnable & ~progress & ~iowait & waiting.any(dim=1) & (wake > S.now)
        S.now.copy_(torch.where(warp, wake, S.now))

    def round(self, S, steps: int):
        steps0 = S.steps.clone()
        self.executor.run_slice_batched(S, steps)
        self.post_slice(S, steps0)
        return S

    def round_aux(self, S, steps: int, mark=None):
        steps0 = S.steps.clone()
        _, n_exec, bailed, hist = self.executor.run_slice_batched_aux(S, steps, mark)
        self.post_slice(S, steps0)
        return S, n_exec, bailed, hist

    def round_exec(self, S, mark=None):
        """One fleet round under the Executive: ``slices`` micro-slices of
        ``quantum`` instructions, each ``schedule_prio -> vmloop -> preempt``
        (under ``cuda`` the kernel at a budget of ``quantum`` with the
        hand-back, ``CudaSliceExecutor.run_slice_exec_batched_aux``; the
        host-driven trace and Oracle engines through their
        ``run_slice_exec_batched``), then the clock, the router and the warp
        once, the clock from the round's instructions.  Returns ``(S,
        task_switches, preemptions, kernel_steps, bailed, bail_hist)``,
        device int64 sums over the micro-slices, zeros where the engine
        reports no kernel counters (the trace engine's tail included, as
        the reference's ``round_exec_host``).  ``mark`` as
        ``run_slice_exec_batched_aux``'s, and "route" after the tail."""
        q, k = self.executive.quantum, self.executive.slices
        ex = self.executor
        dev = S.pc.device
        steps0 = S.steps.clone()
        sums = torch.zeros(4, dtype=torch.int64, device=dev)   # switches, preempts, kernel, bailed
        hist = torch.zeros(self.isa.num_ops + 1, dtype=torch.int64, device=dev)
        for _ in range(k):
            if self.executor_kind == "cuda":
                _, sw, pe, n_exec, bailed, h = ex.run_slice_exec_batched_aux(S, q, mark)
                sums[2] += n_exec.sum()
                sums[3] += bailed.sum()
                hist += h
            else:
                _, sw, pe = ex.run_slice_exec_batched(S, q)
            sums[0] += sw.sum()
            sums[1] += pe.sum()
        self.post_slice(S, steps0)
        if mark is not None:
            mark("route")
        return (S, *sums, hist)

    def rounds_aux(self, S, steps: int, n_rounds: int):
        dev = S.pc.device
        n_sum = torch.zeros((), dtype=torch.int64, device=dev)
        b_sum = torch.zeros((), dtype=torch.int64, device=dev)
        hist = torch.zeros(self.isa.num_ops + 1, dtype=torch.int64, device=dev)
        for _ in range(n_rounds):
            S, n_exec, bailed, h = self.round_aux(S, steps)
            n_sum += n_exec.sum()
            b_sum += bailed.sum()
            hist += h
        return S, n_sum, b_sum, hist


@dataclass
class FleetResult:
    rounds: int
    steps: np.ndarray          # (N,) instructions executed per node
    statuses: list[str]        # task-0 status per node
    outputs: list[str]         # decoded output ring per node


_STATUS_NAME = {ST_DONE: "done", ST_HALT: "halt", ST_ERR: "error"}


class FleetVM:
    """N heterogeneous VM nodes as one device-resident stacked state.

    Usage::

        fleet = FleetVM(cfg, n=64, executor="cuda")
        for i, node in enumerate(fleet.nodes):      # nodes are REXAVMs
            node.launch(node.load(program_for(i)))
        res = fleet.run(max_rounds=200)

    ``device=None`` runs on CUDA and raises when there is none;
    ``device="cpu"`` runs on the CPU (where ``executor="cuda"`` takes the
    kernel's plain version).  ``send dst`` addresses node ``dst`` by fleet
    index.  ``h2d``/``d2h`` count full-state transfers, the ``*_bytes``
    counters every byte moved either way.

    ``obs`` (None | bool | ``ObsConfig``) turns on the telemetry plane:
    each round is counted (``metrics()``), and traced and timed as the
    config says (``export_trace()``).

    ``io_mode`` picks the host-IO service: ``"partial"`` (the default
    without an Executive) moves only the suspended nodes' rows through
    :class:`FleetIOService`; ``"vector"`` (the default with one) moves the
    same rows through the vectorized syscall plane
    (:class:`~repro_torch.exec.syscalls.VectorSyscallService`: one handler
    call per distinct syscall number, not one Python callback per node);
    ``"full"`` syncs the whole state, services every node and pushes it
    back.  ``io_h2d_bytes``/``io_d2h_bytes`` count the service's share.

    ``executive`` (an :class:`~repro_torch.exec.ExecutiveConfig`) runs each
    round as ``slices`` preemptive micro-slices of ``quantum`` instructions,
    dispatched by the priority scheduler (class, then ``prio``, then
    round-robin rotation), with the clock, router and warp once a round.
    Spawn tasks through :class:`~repro_torch.exec.Executive`; the counters
    are live in ``executive_stats()`` and ``metrics()["executive"]``.  It
    excludes ``obs`` (ValueError), as the reference's does.

    ``executor="auto"``: at every ``start()``/``push()`` the Auditor
    verifies each node's loaded programs and plans the engine
    (``analysis.plan_backend``, the reference's policy): ``"cuda"`` when the
    kernel claims every reachable word, ``"trace"`` when every program is a
    predictable single path (its predicted branch sets, the entry path's and
    the steady loop's, are built before the first slice, so no build falls
    inside a run), ``"batched"`` otherwise, the kernel and batched engines
    with the stack checks elided when every entry verified, and the checked
    batched engine when any program has a verifier error.  Until the first
    ``start()`` it runs checked ``batched``.  ``analysis_stats()`` reports
    the plan.

    ``executor="trace"`` (the trace-JIT): ``start()``/``push()`` install each
    node's ``program_key``; ``trace_stats()`` reports the engine's counters
    since this fleet was created (or ``auto`` first planned trace).
    """

    def __init__(
        self,
        cfg: VMConfig | None = None,
        n: int = 2,
        lookup: str = "pht",
        seed: int = 1,
        nodes: list[REXAVM] | None = None,
        executor: str = "batched",
        device=None,
        obs=None,
        io_mode: str | None = None,
        executive=None,
    ):
        if nodes is not None:
            if not nodes:
                raise ValueError("a fleet needs at least one node")
            if len({vm.cfg for vm in nodes}) != 1:
                raise ValueError("fleet nodes must share one VMConfig")
            self.cfg = nodes[0].cfg
            self.nodes = list(nodes)
            self.device = resolve_device(device if device is not None else nodes[0].device)
        else:
            self.cfg = cfg or VMConfig()
            self.device = resolve_device(device)
            self.nodes = [
                REXAVM(self.cfg, lookup=lookup, seed=seed + i, device=self.device)
                for i in range(n)
            ]
        isa = self.nodes[0].isa
        if any(vm.isa is not isa for vm in self.nodes):
            raise ValueError("fleet nodes must share one ISA")
        if executive is not None and obs is not None:
            # The obs plane's phased round and the Executive's sub-sliced
            # round are distinct round shapes, as in the reference.
            raise ValueError(
                "executive and obs are mutually exclusive; Executive "
                "counters are reported via metrics()['executive'] instead"
            )
        self.executive = executive
        if io_mode is None:
            io_mode = "vector" if executive is not None else "partial"
        if io_mode not in ("partial", "full", "vector"):
            raise ValueError(f"unknown io_mode {io_mode!r}")
        self.io_mode = io_mode
        self.n = len(self.nodes)
        self.executor_requested = executor
        self._auto = executor == "auto"
        self._elide = False
        self._analysis = None              # BackendPlan of the last start() (auto)
        self._node_reports = None          # per-node ProgramReport
        if self._auto:
            executor = "batched"           # the safe start: checks on
        self.kernels = self._make_kernels(executor, False)
        self.executor_kind = executor
        self._op_send = isa.opcode["send"]
        self._op_recv = isa.opcode["receive"]
        self._S: VMState | None = None
        if io_mode == "vector":
            from repro_torch.exec.syscalls import VectorSyscallService

            self.io_service = VectorSyscallService(self.nodes)
        else:
            self.io_service = FleetIOService(self.nodes)
        self.h2d = 0
        self.d2h = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.probes = 0
        self.rounds_total = 0
        # Kernel telemetry, accumulated on the device (see kernel_stats()).
        self._kernel_steps_acc = 0
        self._bailed_acc = 0
        self._bail_hist_acc = 0
        self._total_steps_acc = 0
        # The trace engine's counters are monotonic and shared (one engine a
        # VMConfig): keep this fleet's baseline and report deltas.
        self._trace0 = self.kernels.executor.stats() if executor == "trace" else None
        self._trace_steps_total = 0
        # Executive telemetry: device sums like the kernel's, plus the
        # admissions (Executive.spawn) and the task deadline misses.
        self._task_switches_acc = 0
        self._preempts_acc = 0
        self._exec_slices = 0
        self._spawns_admitted = 0
        self._spawns_rejected = 0
        # Sticky per-(node, task slot) deadline-miss flags, cleared when a
        # slot frees; the total counts each occupancy's first miss once.
        self._deadline_missed = np.zeros((self.n, self.cfg.max_tasks), bool)
        self._task_deadline_miss_total = 0
        # The telemetry plane: off by default — no extra device outputs, no
        # per-phase synchronization, nothing accumulated.
        from repro_torch.obs.metrics import normalize_obs

        self.obs = normalize_obs(obs)
        self._counters = None              # device ObsCounters
        self._tracer = None
        self._deadline = None
        if self.obs is not None:
            from repro_torch.obs.deadline import DeadlineMonitor
            from repro_torch.obs.metrics import zero_counters
            from repro_torch.obs.tracing import RoundTracer

            self._counters = zero_counters(self.n, isa, self.device)
            self._tracer = RoundTracer(ring=self.obs.trace_ring, enabled=self.obs.trace,
                                       profiler=self.obs.profiler)
            self._deadline = DeadlineMonitor(self.obs.deadline_wall_ms)
            self.io_service.tracer = self._tracer

    @classmethod
    def from_nodes(cls, nodes: list[REXAVM], **kw) -> "FleetVM":
        """Stack pre-configured REXAVM nodes into one fleet."""
        return cls(nodes=nodes, **kw)

    @property
    def io_h2d_bytes(self) -> int:
        """IO-service bytes host -> device."""
        return self.io_service.h2d_bytes

    @property
    def io_d2h_bytes(self) -> int:
        """IO-service bytes device -> host."""
        return self.io_service.d2h_bytes

    # -- telemetry ---------------------------------------------------------------

    def kernel_stats(self) -> dict:
        """Instructions retired inside the vmloop kernel vs the interpreter
        (zeros under the batched, Oracle and trace executors, as the
        reference's under its non-kernel engines), with the keys and meanings of
        the reference's ``pallas_stats()``: ``kernel_steps`` in the kernel,
        ``fallback_steps`` in the interpreter, ``bailed_node_rounds`` the
        node-rounds with at least one bail, and ``bail_hist`` each declined
        word (``task``, ``rnd`` or ``fios/trap``) with the node-rounds that
        met it at least once.

        The values differ from the reference's: its kernel stops at a
        node's first bail of a slice and the interpreter runs the rest, so
        a word met later in that slice (``rnd`` after ``task``) is never
        counted.  Here each declined word is handed to the interpreter and
        the kernel resumes after it, so ``fallback_steps`` counts only the
        declined instructions, and a node-round that meets ``task`` and
        then ``rnd`` counts once under each.  Under an Executive a
        "node-round" is a node's micro-slice, and ``exec_slices`` counts
        the micro-slices the kernel engine drove."""
        kernel = int(self._kernel_steps_acc)
        total = int(self._total_steps_acc)
        fallback = max(total - kernel, 0)
        hist = self._bail_hist_acc
        bail_hist = (
            bail_hist_dict(self.kernels.isa, hist.cpu().numpy())
            if isinstance(hist, torch.Tensor) else {}
        )
        return {
            "executor": self.executor_kind,
            "kernel_steps": kernel,
            "fallback_steps": fallback,
            "total_steps": total,
            "bailed_frac": fallback / total if total else 0.0,
            "bailed_node_rounds": int(self._bailed_acc),
            "bail_hist": bail_hist,
            "exec_slices": int(self._exec_slices) if self.executor_kind == "cuda" else 0,
        }

    def trace_stats(self) -> dict:
        """Trace-engine telemetry with the reference's keys and values,
        counted since this fleet was created: traces recorded and built,
        specialized steps, guard exits (deopts into the generic tail), the
        share of executed instructions that ran specialized, per-program
        groups, and the Executive micro-slices the engine drove.  The same
        keys, zeroed, under every other executor."""
        if self._trace0 is None:
            return {
                "executor": self.executor_kind,
                "traces_recorded": 0,
                "traces_compiled": 0,
                "spec_steps": 0,
                "guard_exits": 0,
                "total_steps": 0,
                "specialized_frac": 0.0,
                "groups": {},
                "exec_slices": 0,
            }
        now, base = self.kernels.executor.stats(), self._trace0
        spec = now["spec_steps"] - base["spec_steps"]
        total = self._trace_steps_total
        return {
            "executor": self.executor_kind,
            "traces_recorded": now["traces_recorded"] - base["traces_recorded"],
            "traces_compiled": now["traces_compiled"] - base["traces_compiled"],
            "spec_steps": spec,
            "guard_exits": now["guard_exits"] - base["guard_exits"],
            "total_steps": total,
            "specialized_frac": spec / total if total else 0.0,
            "groups": now["groups"],
            "exec_slices": int(self._exec_slices),
        }

    def executive_stats(self) -> dict:
        """Executive and syscall-plane telemetry with the reference's keys,
        zeroed without an Executive and, for the ``svc_*`` keys, under the
        per-node ``FleetIOService``.  ``task_switches``/``preemptions`` are
        the device sums of the Executive round; ``task_deadline_misses``
        counts each task-slot occupancy's first virtual-clock deadline miss;
        ``svc_batches`` against ``svc_scalar_calls`` shows the vectorized
        service (one handler call per distinct syscall, not one per node)."""
        svc = self.io_service
        ecfg = self.executive
        return {
            "executor": self.executor_kind,
            "enabled": ecfg is not None,
            "quantum": int(ecfg.quantum) if ecfg else 0,
            "slices_per_round": int(ecfg.slices) if ecfg else 0,
            "exec_slices": int(self._exec_slices),
            "task_switches": int(self._task_switches_acc),
            "preemptions": int(self._preempts_acc),
            "spawns_admitted": int(self._spawns_admitted),
            "spawns_rejected": int(self._spawns_rejected),
            "task_deadline_misses": int(self._task_deadline_miss_total),
            "tasks_missed": int(self._deadline_missed.sum()),
            "syscalls": int(getattr(svc, "syscalls", 0)),
            "svc_batches": int(getattr(svc, "svc_batches", 0)),
            "svc_scalar_calls": int(getattr(svc, "scalar_calls", 0)),
            "svc_posts": int(getattr(svc, "posts", 0)),
            "svc_post_drops": int(getattr(svc, "post_drops", 0)),
        }

    def transfer_stats(self) -> dict:
        """All movement counters in one dict (serve monitor / benchmarks):
        the reference's keys.  ``io_syscalls``/``io_svc_batches`` come from
        the vectorized syscall plane (0 under the per-node service)."""
        svc = self.io_service
        return {
            "executor": self.executor_kind,
            "rounds": self.rounds_total,
            "h2d": self.h2d,
            "d2h": self.d2h,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "io_services": svc.services,
            "io_nodes_serviced": svc.nodes_serviced,
            "io_h2d_bytes": svc.h2d_bytes,
            "io_d2h_bytes": svc.d2h_bytes,
            "io_syscalls": int(getattr(svc, "syscalls", 0)),
            "io_svc_batches": int(getattr(svc, "svc_batches", 0)),
            "probes": self.probes,
        }

    def metrics(self):
        """One schema-stable telemetry snapshot (``FleetMetrics``): the
        device counters, the round-latency monitor and the stats dicts,
        with the reference's key structure under every executor and with
        obs on or off (zeroed where nothing was measured).  The one device
        read is the counters', and only when obs is on."""
        from repro_torch.obs.deadline import DeadlineMonitor
        from repro_torch.obs.metrics import FleetMetrics, hist_to_dict, n_bins

        isa = self.kernels.isa
        if self._counters is not None:
            c = [x.cpu().numpy() for x in self._counters]
            op, mbox_high, mbox_drops, io_susp, deopts, miss, rounds_observed = c
        else:
            op = np.zeros(n_bins(isa), np.int64)
            miss = np.zeros(self.n, np.int64)
            mbox_high = mbox_drops = io_susp = deopts = rounds_observed = 0
        counters = {
            "op_retired": hist_to_dict(op, isa),
            "instructions": int(op.sum()),
            "mbox_high": int(mbox_high),
            "mbox_drops": int(mbox_drops),
            "io_susp": int(io_susp),
            "deopts": int(deopts),
            "deadline_ms": int(self.obs.deadline_ms) if self.obs else 0,
            "deadline_miss": [int(x) for x in miss],
            "deadline_miss_total": int(miss.sum()),
            "rounds_observed": int(rounds_observed),
        }
        latency = (self._deadline if self._deadline is not None else DeadlineMonitor()).snapshot()
        sections = {}
        for name, stats in (("pallas", self.kernel_stats()), ("trace", self.trace_stats()),
                            ("transfers", self.transfer_stats()),
                            ("executive", self.executive_stats())):
            stats.pop("executor", None)
            sections[name] = stats
        sections["transfers"].pop("rounds", None)
        return FleetMetrics(executor=self.executor_kind, rounds=self.rounds_total,
                            counters=counters, latency=latency, **sections)

    def export_trace(self, path=None):
        """The recorded round-phase spans as Chrome trace-event JSON (open
        in chrome://tracing or ui.perfetto.dev), written to ``path`` when
        given; returns the payload.  Needs ``obs=ObsConfig(trace=True)``;
        without it the export is valid and empty."""
        from repro_torch.obs.tracing import RoundTracer, export_chrome_trace

        return export_chrome_trace(self._tracer or RoundTracer(enabled=False), path)

    # -- static analysis (the Auditor) ---------------------------------------------

    def _make_kernels(self, executor: str, elide_checks: bool) -> FleetKernels:
        isa = self.nodes[0].isa
        return FleetKernels(self.cfg, isa if isa is not get_isa() else None, executor,
                            elide_checks, self.executive)

    def _analyze_nodes(self) -> list:
        """The static verifier over every node's live task entries (on the
        host, against the states about to be stacked)."""
        from repro_torch.analysis.verifier import analyze_vm

        return [analyze_vm(vm) for vm in self.nodes]

    def _resolve_auto(self) -> None:
        """executor="auto": verify, plan the engine, and swap the kernels
        when the plan changes.

        Runs at every start()/push(), exactly when compiles or incremental
        code loads land, so the plan reflects the programs about to run.
        Programs with verifier errors are not rejected here (the CLI is the
        reject path): they run on the checked batched engine.  On a trace
        plan every branch set the engine will record (each node's entry path
        and steady loop, ``predict_branch_sets``) is built now, so the first
        slice finds its steps ready and ``traces_compiled`` stays still
        during the run."""
        from repro_torch.analysis.feasibility import plan_backend, predict_branch_sets

        reports = self._analyze_nodes()
        branch_sets = []          # per node: the entry path's set (the plan's input)
        aot_sets = []             # every set the engine will record
        for vm, rep in zip(self.nodes, reports):
            sets = (predict_branch_sets(vm.state.cs.cpu().numpy(), rep.entries[0].pc, vm.isa)
                    if rep.entries else ())
            branch_sets.append(sets[0] if sets else None)
            aot_sets.extend(sets)
        plan = plan_backend(reports, branch_sets)
        self._node_reports = reports
        self._analysis = plan
        if (plan.executor, plan.elide_checks) != (self.executor_kind, self._elide):
            self.kernels = self._make_kernels(plan.executor, plan.elide_checks)
            self.executor_kind = plan.executor
            self._elide = plan.elide_checks
            if plan.executor == "trace" and self._trace0 is None:
                self._trace0 = self.kernels.executor.stats()
        if plan.executor == "trace":
            eng = self.kernels.executor.engine
            for bs in aot_sets:
                eng.fn_for(bs)

    def analysis_stats(self) -> dict:
        """Auditor telemetry with the reference's keys.  Under
        ``executor="auto"`` it reflects the plan of the last start()/push();
        other executors analyze on the first call (on the host: it never
        touches the device state).  ``executor`` is the port's engine name
        (``"cuda"`` where the reference says ``"pallas"``)."""
        from repro_torch.analysis.feasibility import bail_words

        if self._node_reports is None:
            self._node_reports = self._analyze_nodes()
        reports = self._node_reports
        plan = self._analysis
        verdicts = {"verified": 0, "flagged": 0, "error": 0}
        for r in reports:
            verdicts[r.verdict] += 1
        predicted = sorted(frozenset().union(*(bail_words(r) for r in reports))
                           if reports else frozenset())
        return {
            "executor": self.executor_kind,
            "requested": self.executor_requested,
            "auto": self._auto,
            "elide_checks": self._elide,
            "verdicts": verdicts,
            "predicted_bail_words": predicted,
            "wcet": [r.wcet for r in reports],
            "aot_branch_sets": (sum(1 for bs in plan.branch_sets if bs is not None)
                                if plan else 0),
            "reasons": list(plan.reasons) if plan else [],
            "diagnostics": [str(d) for r in reports for d in r.diagnostics][:64],
        }

    # -- state movement ------------------------------------------------------------

    def start(self) -> None:
        """Stack the nodes' host states into the device-resident state.
        Under ``executor="auto"`` the Auditor runs first: verify the loaded
        programs, resolve the engine and build the predicted trace steps;
        under the trace engine the nodes' program keys are installed."""
        if self._auto:
            self._resolve_auto()
        stacked = vms.stack_states([vm.state for vm in self.nodes])
        self._S = vms.to_device(stacked, self.device)
        self.h2d += 1
        self.h2d_bytes += vms.state_nbytes(stacked)
        if self.executor_kind == "trace":
            # start()/push() is when compiles and code loads land: a changed
            # code segment re-keys its trace-cache entries (stale keys would
            # still be byte-safe, only slower).
            self.kernels.executor.set_program_keys([program_key(vm.state.cs) for vm in self.nodes])

    def sync(self) -> None:
        """Copy the stacked state back into the nodes' host frontends."""
        assert self._S is not None, "fleet not started"
        host = vms.to_host(self._S)
        for i, vm in enumerate(self.nodes):
            vm.state = vms.unstack(host, i)
        self.d2h += 1
        self.d2h_bytes += vms.state_nbytes(host)

    def push(self) -> None:
        """Re-stack (possibly host-mutated) node states onto the device."""
        self.start()

    # -- execution -------------------------------------------------------------------

    def _probe(self):
        """Small device-to-host read of the scheduler-visible state; under an
        Executive ``now`` and ``deadline`` ride along for its deadline
        misses (else they are None, and the plain probe stays three copies)."""
        self.probes += 1
        S = self._S
        tstatus, io_op, steps = (x.cpu().numpy() for x in (S.tstatus, S.io_op, S.steps))
        if self.executive is None:
            return tstatus, io_op, steps, None, None
        return tstatus, io_op, steps, S.now.cpu().numpy(), S.deadline.cpu().numpy()

    def _service_host_io(self, node_mask: np.ndarray) -> bool:
        """Service the host-IO suspensions of the masked nodes: ``partial``
        and ``vector`` move only those nodes' rows through the IO service;
        ``full`` syncs the whole state, services every node and pushes it
        back."""
        if self.io_mode in ("partial", "vector"):
            svc = self.io_service
            d2h0, h2d0 = svc.d2h_bytes, svc.h2d_bytes
            self._S, progress = svc.service(self._S, np.flatnonzero(node_mask))
            # The headline byte counters include the IO service's share.
            self.d2h_bytes += svc.d2h_bytes - d2h0
            self.h2d_bytes += svc.h2d_bytes - h2d0
            return progress
        self.sync()
        progress = False
        for vm in self.nodes:
            progress |= vm._service_io(route_net=False)
        self.push()
        return progress

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _round_obs(self, steps: int) -> None:
        """One observed round: schedule -> execute -> clock and router ->
        warp, the phases of ``FleetKernels.round``, with the round's
        counters folded into the device ``ObsCounters``.  Spans (trace on)
        close each phase with a device synchronize, and round timing
        (``time_rounds`` or a wall deadline) one synchronize a round;
        otherwise the round adds none."""
        kern, ex, tr, cfg_obs = self.kernels, self.kernels.executor, self._tracer, self.obs
        timing = cfg_obs.time_rounds or cfg_obs.deadline_wall_ms > 0
        t0 = time.perf_counter() if timing else 0.0
        S = self._S
        steps0 = S.steps.clone()
        with tr.span("schedule"):
            found = ex.obs_schedule(S)
            if tr.enabled:
                self._sync_device()
        with tr.span("execute"):
            aux = ex.obs_execute(S, steps, found)
            if tr.enabled:
                self._sync_device()
        with tr.span("router"):
            inc, drops, depth, progress = kern.clock_route(S, steps0)
            if tr.enabled:
                self._sync_device()
        with tr.span("warp"):
            kern.warp(S, progress)
            if tr.enabled:
                self._sync_device()
        self._counters = kern.accum(self._counters, aux, inc, drops, depth, cfg_obs.deadline_ms)
        if self.executor_kind == "cuda":
            self._kernel_steps_acc = self._kernel_steps_acc + aux.kernel_steps
            self._bailed_acc = self._bailed_acc + aux.bailed
            self._bail_hist_acc = self._bail_hist_acc + aux.bail_hist
        if timing:
            self._sync_device()
            self._deadline.record((time.perf_counter() - t0) * 1e3)
        tr.tick()

    def run(
        self,
        max_rounds: int = 10_000,
        steps: int | None = None,
        service_every: int = 1,
    ) -> FleetResult:
        """Run whole fleet rounds on the device until all nodes finish.

        ``service_every`` sets how often the host probes for host IO and
        termination; between probes whole rounds (slice, router, warp) run
        back to back on the device."""
        steps = steps or self.cfg.steps_per_slice
        if self._S is None:
            self.start()
        steps0 = self._S.steps.cpu().numpy().astype(np.int64)
        rounds = 0
        stall = 0
        last_steps_sum = -1
        kern = self.kernels
        while rounds < max_rounds:
            if self.obs is not None:
                # Observed rounds run phased and one at a time, so that each
                # is counted, traced and timed on its own.
                self._round_obs(steps)
                rounds += 1
            elif self.executive is not None:
                # slices micro-slices of quantum instructions, then the
                # clock, router and warp once; the counters stay on the device.
                self._S, sw, pe, ne, bl, hist = kern.round_exec(self._S)
                self._task_switches_acc = self._task_switches_acc + sw
                self._preempts_acc = self._preempts_acc + pe
                self._kernel_steps_acc = self._kernel_steps_acc + ne
                self._bailed_acc = self._bailed_acc + bl
                self._bail_hist_acc = self._bail_hist_acc + hist
                self._exec_slices += self.executive.slices
                rounds += 1
            elif kern.rounds_aux is not None and service_every > 1:
                chunk = min(service_every, max_rounds - rounds)
                self._S, n_sum, b_sum, hist = kern.rounds_aux(self._S, steps, chunk)
                self._kernel_steps_acc = self._kernel_steps_acc + n_sum
                self._bailed_acc = self._bailed_acc + b_sum
                self._bail_hist_acc = self._bail_hist_acc + hist
                rounds += chunk
            elif kern.round_aux is not None:
                self._S, n_exec, bailed, hist = kern.round_aux(self._S, steps)
                self._kernel_steps_acc = self._kernel_steps_acc + n_exec.sum()
                self._bailed_acc = self._bailed_acc + bailed.sum()
                self._bail_hist_acc = self._bail_hist_acc + hist
                rounds += 1
            else:
                kern.round(self._S, steps)
                rounds += 1
            if rounds % service_every != 0 and rounds < max_rounds:
                continue
            tstatus, io_op, steps_now, now_v, deadline_v = self._probe()
            if self.executive is not None:
                # Task deadline misses: a live slot whose virtual clock has
                # passed its (nonzero) deadline, counted once an occupancy.
                active = tstatus != ST_FREE
                missed_now = (deadline_v > 0) & (now_v[:, None] > deadline_v) & active
                self._task_deadline_miss_total += int((missed_now & ~self._deadline_missed).sum())
                self._deadline_missed = (self._deadline_missed | missed_now) & active
            host_io = (
                (tstatus == ST_IOWAIT)
                & (io_op != 0)
                & (io_op != self._op_send)
                & (io_op != self._op_recv)
            )
            serviced = False
            if host_io.any():
                serviced = self._service_host_io(host_io.any(axis=1))
            # A node is finished only when task 0 is terminal AND no other
            # task is runnable, waiting, or IO-suspended.
            task0_term = np.isin(tstatus[:, 0], (ST_DONE, ST_HALT, ST_ERR))
            runnable = (tstatus == ST_YIELD).any(axis=1)
            waiting = np.isin(tstatus, (ST_SLEEP, ST_EVENT)).any(axis=1)
            iowait = (tstatus == ST_IOWAIT).any(axis=1)
            if (task0_term & ~runnable & ~waiting & ~iowait).all():
                break
            steps_sum = int(steps_now.astype(np.int64).sum())
            if steps_sum == last_steps_sum and not serviced:
                stall += 1
                if stall >= 3:
                    break              # fleet-wide deadlock / quiescence
            else:
                stall = 0
            last_steps_sum = steps_sum
        self.sync()
        self.rounds_total += rounds
        executed = self._S.steps.cpu().numpy().astype(np.int64) - steps0
        self._total_steps_acc += int(executed.sum())
        self._trace_steps_total += int(executed.sum())
        self._S = None
        task0 = [int(vm.state.tstatus[0]) for vm in self.nodes]
        return FleetResult(
            rounds=rounds,
            steps=executed,
            statuses=[_STATUS_NAME.get(s, "running") for s in task0],
            outputs=[vm.output() for vm in self.nodes],
        )


# ---------------------------------------------------------------------------
# Host-routed reference (the operational specification of one fleet round)
# ---------------------------------------------------------------------------

_REF_ORACLES: dict = {}


def _reference_oracle(cfg: VMConfig, isa: ISA):
    """The plain-Python Oracle that ``reference_round``'s Executive rounds
    share (the nodes' own executors may be device-backed)."""
    from repro_torch.core.vm.oracle import Oracle

    key = (cfg, id(isa))
    if key not in _REF_ORACLES:
        _REF_ORACLES[key] = Oracle(cfg, isa)
    return _REF_ORACLES[key]


def reference_round(nodes: list[REXAVM], steps: int | None = None,
                    obs: dict | None = None, executive=None) -> list[bool]:
    """One fleet round over independent host-looped REXAVMs: slice every
    node, advance its clock, route all sends then all receives through the
    host (same order, rings, backpressure and drop rules as the router),
    then the per-node time warp.  Returns the per-node progress flags.

    ``obs``, when given, is a dict the round's router counters accumulate
    into, as the reference's: ``drops`` (messages to out-of-range
    destinations) and ``depth_peak`` (the deepest mailbox after the send
    phase) — the definitions of ``mbox_drops`` and ``mbox_high``; under an
    Executive it also grows ``task_switches`` and ``preemptions``.

    ``executive`` (an ``ExecutiveConfig``) runs ``slices`` micro-slices of
    ``quantum`` instructions per node through the Oracle's priority
    scheduler (``Oracle.run_slice_exec``), and advances the clock once from
    the round's instructions, as ``FleetKernels.round_exec``."""
    cfg = nodes[0].cfg
    isa = nodes[0].isa
    N, T = len(nodes), cfg.max_tasks
    MB, DS = cfg.mbox_size, cfg.ds_size
    op_send, op_recv = isa.opcode["send"], isa.opcode["receive"]
    steps = steps or cfg.steps_per_slice
    oracle = _reference_oracle(cfg, isa) if executive is not None else None
    for vm in nodes:
        before = int(vm.state.steps)
        if oracle is None:
            vm._slice(steps)
        else:
            for _ in range(executive.slices):
                _, _, switched, preempted = oracle.run_slice_exec(vm.state, executive.quantum)
                if obs is not None:
                    obs["task_switches"] = obs.get("task_switches", 0) + switched
                    obs["preemptions"] = obs.get("preemptions", 0) + preempted
        executed = int(vm.state.steps) - before
        vm.state.now.fill_(int(vm.state.now) + max(1, executed * cfg.us_per_instr // 1000))
    progress = [False] * N
    arrays = [{f: getattr(vm.state, f).numpy() for f in VMState._fields} for vm in nodes]
    for i, st in enumerate(arrays):                       # all sends
        for t in range(T):
            if int(st["tstatus"][t]) != ST_IOWAIT or int(st["io_op"][t]) != op_send:
                continue
            dsp = int(st["dsp"][t])
            dst = int(st["ds"][t, max(dsp - 1, 0)])
            v = int(st["ds"][t, max(dsp - 2, 0)])
            if 0 <= dst < N:
                m = arrays[dst]
                if int(m["mbox_wr"]) - int(m["mbox_rd"]) >= MB:
                    continue           # backpressure: sender stays suspended
                slot = int(m["mbox_wr"]) % MB
                m["mbox"][2 * slot] = i
                m["mbox"][2 * slot + 1] = v
                m["mbox_wr"][...] = int(m["mbox_wr"]) + 1
            elif obs is not None:
                obs["drops"] = obs.get("drops", 0) + 1
            st["dsp"][t] = dsp - 2
            st["pc"][t] = int(st["pc"][t]) + 1
            st["io_op"][t] = 0
            st["tstatus"][t] = ST_YIELD
            progress[i] = True
    if obs is not None:
        depth = max(int(st["mbox_wr"]) - int(st["mbox_rd"]) for st in arrays)
        obs["depth_peak"] = max(obs.get("depth_peak", 0), depth)
    for i, st in enumerate(arrays):                       # all receives
        for t in range(T):
            if int(st["tstatus"][t]) != ST_IOWAIT or int(st["io_op"][t]) != op_recv:
                continue
            if int(st["mbox_wr"]) <= int(st["mbox_rd"]):
                continue               # empty mailbox: stay suspended
            slot = int(st["mbox_rd"]) % MB
            src, v = int(st["mbox"][2 * slot]), int(st["mbox"][2 * slot + 1])
            st["ds"][t, min(max(int(st["dsp"][t]), 0), DS - 1)] = src
            st["ds"][t, min(max(int(st["dsp"][t]) + 1, 0), DS - 1)] = v
            st["dsp"][t] = int(st["dsp"][t]) + 2
            st["mbox_rd"][...] = int(st["mbox_rd"]) + 1
            st["pc"][t] = int(st["pc"][t]) + 1
            st["io_op"][t] = 0
            st["tstatus"][t] = ST_YIELD
            progress[i] = True
    for i, st in enumerate(arrays):                       # time warp
        sts = [int(s) for s in st["tstatus"]]
        waiting = [k for k, s in enumerate(sts) if s in (ST_SLEEP, ST_EVENT)]
        if ST_YIELD not in sts and not progress[i] and ST_IOWAIT not in sts and waiting:
            wake = min(int(st["timeout"][k]) for k in waiting)
            if wake > int(st["now"]):
                st["now"][...] = wake
    return progress
