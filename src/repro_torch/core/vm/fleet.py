"""Device-resident VM fleet — N cooperating REXAVM nodes, one stacked state
(counterpart of ``repro.core.vm.fleet``).

``FleetVM`` holds N node states as ONE stacked ``VMState`` on the device.
A round is three layers, all updating that state in place:

  1. one micro-slice per node (``schedule -> vmloop -> preempt``) on the
     batched interpreter (``executor="batched"``), on the vmloop CUDA
     kernel, which hands each word it declines to the interpreter
     (``executor="cuda"``), or through the plain-Python Oracle on the host
     (``executor="oracle"``);
  2. the virtual clock: ``now += max(1, executed * us_per_instr // 1000)``;
  3. mailbox routing (``routing.build_router``): all sends in (node, task)
     order, then all receives;
  4. the time warp to the earliest wake-up of nodes with nothing runnable,
     no routing progress and no IO suspension.

Host IO (FIOS calls, ``out``/``in``) is found by a small per-round status
probe and serviced by :class:`~repro_torch.core.vm.ios.FleetIOService`,
which moves only the suspended nodes' rows.  ``reference_round`` is the
same round over independent host-looped nodes.

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
    ST_HALT,
    ST_IOWAIT,
    ST_SLEEP,
    ST_YIELD,
    get_isa,
)
from repro_torch.core.vm.vmstate import VMState

I32 = torch.int32
_I32_MAX = 2 ** 31 - 1

EXECUTORS = ("batched", "cuda", "oracle")


class FleetKernels:
    """Slice + routing + clock for one (VMConfig, ISA, executor).

    ``round(S, steps)`` is one fleet round; ``round_aux`` also returns the
    kernel's per-node step counts (over all its launches of the slice),
    whether each node bailed, and per opcode the nodes that met it as a
    declined word (``executor="cuda"`` only; None otherwise; ``mark`` as
    ``CudaSliceExecutor.run_slice_batched_aux``'s); ``rounds_aux(S, steps,
    n)`` runs ``n`` whole rounds and sums those."""

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, executor: str = "batched"):
        self.cfg = cfg
        self.isa = isa or get_isa()
        if executor == "batched":
            self.executor = BatchedSliceExecutor(cfg, isa)
        elif executor == "cuda":
            self.executor = CudaSliceExecutor(cfg, isa)
        elif executor == "oracle":
            self.executor = OracleFleetExecutor(cfg, isa)
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
        self.n = len(self.nodes)
        self.kernels = FleetKernels(self.cfg, isa if isa is not get_isa() else None, executor)
        self.executor_kind = executor
        self._op_send = isa.opcode["send"]
        self._op_recv = isa.opcode["receive"]
        self._S: VMState | None = None
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

    # -- telemetry ---------------------------------------------------------------

    def kernel_stats(self) -> dict:
        """Instructions retired inside the vmloop kernel vs the interpreter
        (zeros under the batched executor), with the keys and meanings of
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
        then ``rnd`` counts once under each."""
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
            "exec_slices": 0,
        }

    def trace_stats(self) -> dict:
        """The reference's trace-executor keys, zeroed: the trace-JIT is not
        in the port yet (``metrics()`` keeps its schema)."""
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

    def executive_stats(self) -> dict:
        """The reference's Executive and syscall-plane keys, zeroed as the
        reference's are without an Executive (not in the port yet)."""
        return {
            "executor": self.executor_kind,
            "enabled": False,
            "quantum": 0,
            "slices_per_round": 0,
            "exec_slices": 0,
            "task_switches": 0,
            "preemptions": 0,
            "spawns_admitted": 0,
            "spawns_rejected": 0,
            "task_deadline_misses": 0,
            "tasks_missed": 0,
            "syscalls": 0,
            "svc_batches": 0,
            "svc_scalar_calls": 0,
            "svc_posts": 0,
            "svc_post_drops": 0,
        }

    def transfer_stats(self) -> dict:
        """All movement counters in one dict (serve monitor / benchmarks):
        the reference's keys.  The syscall-plane fields are 0: the port has
        only the per-node ``FleetIOService`` so far."""
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
            "io_syscalls": 0,
            "io_svc_batches": 0,
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

    # -- state movement ------------------------------------------------------------

    def start(self) -> None:
        """Stack the nodes' host states into the device-resident state."""
        stacked = vms.stack_states([vm.state for vm in self.nodes])
        self._S = vms.to_device(stacked, self.device)
        self.h2d += 1
        self.h2d_bytes += vms.state_nbytes(stacked)

    def sync(self) -> None:
        """Copy the stacked state back into the nodes' host frontends."""
        assert self._S is not None, "fleet not started"
        host = vms.to_host(self._S)
        for i, vm in enumerate(self.nodes):
            vm.state = vms.unstack(host, i)
        self.d2h += 1
        self.d2h_bytes += vms.state_nbytes(host)

    # -- execution -------------------------------------------------------------------

    def _probe(self):
        """Small device-to-host read of the scheduler-visible state."""
        self.probes += 1
        S = self._S
        return (
            S.tstatus.cpu().numpy(),
            S.io_op.cpu().numpy(),
            S.steps.cpu().numpy(),
        )

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
            tstatus, io_op, steps_now = self._probe()
            host_io = (
                (tstatus == ST_IOWAIT)
                & (io_op != 0)
                & (io_op != self._op_send)
                & (io_op != self._op_recv)
            )
            serviced = False
            if host_io.any():
                svc = self.io_service
                d2h0, h2d0 = svc.d2h_bytes, svc.h2d_bytes
                self._S, serviced = svc.service(self._S, np.flatnonzero(host_io.any(axis=1)))
                self.d2h_bytes += svc.d2h_bytes - d2h0
                self.h2d_bytes += svc.h2d_bytes - h2d0
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

def reference_round(nodes: list[REXAVM], steps: int | None = None,
                    obs: dict | None = None) -> list[bool]:
    """One fleet round over independent host-looped REXAVMs: slice every
    node, advance its clock, route all sends then all receives through the
    host (same order, rings, backpressure and drop rules as the router),
    then the per-node time warp.  Returns the per-node progress flags.

    ``obs``, when given, is a dict the round's router counters accumulate
    into, as the reference's: ``drops`` (messages to out-of-range
    destinations) and ``depth_peak`` (the deepest mailbox after the send
    phase) — the definitions of ``mbox_drops`` and ``mbox_high``."""
    cfg = nodes[0].cfg
    isa = nodes[0].isa
    N, T = len(nodes), cfg.max_tasks
    MB, DS = cfg.mbox_size, cfg.ds_size
    op_send, op_recv = isa.opcode["send"], isa.opcode["receive"]
    steps = steps or cfg.steps_per_slice
    for vm in nodes:
        before = int(vm.state.steps)
        vm._slice(steps)
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
