"""Trace-JIT slice engine — program-specialized slices (counterpart of
``repro.core.vm.trace``).

The paper's REXAVM is fast because text is compiled to bytecode once and
then executed without re-deciding each step.  The fleet's generic engines
still decide every step: the batched interpreter groups the nodes by their
next instruction, and the vmloop kernel dispatches through its table and
hands the words it declines (``task``, ``rnd``, FIOS) back to the
interpreter.  At fleet scale, though, thousands of nodes run a handful of
programs.  This engine removes the per-step decision for exactly that
case, as a meta-tracer does: the bytecode is green (constant per program),
the data red.

Per micro-slice:

  1. the scheduler runs on the device (as in the generic engines);
  2. one small device-to-host probe reads each node's running flag and
     entry pc, and the host groups the running nodes by ``(program_key,
     entry pc)``;
  3. per group, the port's :class:`~repro_torch.core.vm.oracle.Oracle`
     runs once as a host recorder over a copy of one node, logging the
     ``(pc, instruction cell)`` sequence it fetches (``Oracle.trace_hook``)
     up to ``min(steps, TRACE_MAX)`` fetches; the first revisited pc closes
     the path (``loop_start``);
  4. the path runs as specialized steps: one
     :meth:`~repro_torch.core.vm.interp.Interpreter.static_step` per
     distinct ``(tag, opcode)`` of the path (its ``branch_set``), built
     once per branch set, each guarded on ``pc == recorded pc`` and
     ``cs[pc] == recorded cell``; past the end the path wraps to
     ``loop_start``, so one short recording specializes any number of
     loop iterations;
  5. a failed guard (a branch taken the other way, ``receive`` finding a
     message, self-modified code, an IO suspension) deoptimizes: the node
     stops consuming the path, and the shared generic tail, the vmloop
     kernel's passes with the hand-back (``CudaSliceExecutor._execute``),
     runs each node's remaining budget, then the preempt.

Position ``k`` of the path is the same for every node still alive in a
group: it advances whether or not a node's guard held, and a node whose
guard failed stays out.  So the host knows each iteration's kind, and the
iteration is one static step on the rows whose guard holds, found by one
host sync (the reference's ``while_loop`` condition makes the same
decision on the device).  Each specialized step equals the interpreter's
step under a true guard, and the tail is the generic engine itself, so
the composition is byte-exact with ``executor="batched"``, ``"cuda"`` and
``reference_round`` however paths are recorded, shared or stale: the
guards, not the cache, carry correctness.  The recorder is the Oracle,
which differs from the interpreter on some edge values (INT_MIN division
and ``pick``, out-of-range stores, LUT words at the int32 extremes); a
recorded path may then disagree with execution, and the guards stop
consumption there.

Traces are cached by ``(program_key, entry pc, cap)``; the built steps by
branch set (``traces_compiled`` counts the builds).  On a sharded state
(``TraceJitExecutor(mesh=)``) every step above runs per shard: program
groups form within a shard, and all shards share the one trace cache.  Engines are cached
per ``VMConfig`` for the default ISA, like ``interp_for``.  On the card the
tail launches the vmloop kernel with per-node budgets and never falls back
to its plain version; on the CPU it takes the plain version, as
``executor="cuda"`` does.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.executor import CudaSliceExecutor
from repro_torch.core.vm.interp import interp_for
from repro_torch.core.vm.oracle import Oracle
from repro_torch.core.vm.spec import ISA, ST_IOWAIT, ST_RUN, TAG_OP, get_isa
from repro_torch.core.vm.vmstate import resolve_device

I32 = torch.int32

# A slice records at most this many fetches; the path's loop wrap and the
# generic tail cover the rest of its budget.
TRACE_MAX = 128


def program_key(cs) -> str:
    """Green key of a node's program: the blake2b hash (8 bytes) of its code
    segment as contiguous little-endian int32 (bytecode and compiled
    dispatch both live there); the reference's hex for the same cells."""
    if isinstance(cs, torch.Tensor):
        cs = cs.detach().cpu().numpy()
    data = np.ascontiguousarray(cs, dtype="<i4").tobytes()
    return hashlib.blake2b(data, digest_size=8).hexdigest()


class _Trace:
    """One recorded hot path: the fetch sequence of a program from one entry
    pc.  ``kinds`` maps each position to an index into ``branch_set``, the
    sorted distinct ``(tag, opcode)`` pairs of the path (the build key);
    ``loop_start`` is the position the path re-enters when its last fetch
    revisited an earlier pc.  Arrays are padded to ``TRACE_MAX``."""

    __slots__ = (
        "pcs", "instrs", "kinds", "length", "loop_start", "branch_set",
        "num_ops", "_hist_prefix",
    )

    def __init__(self, rec: list[tuple[int, int]], num_ops: int, loop_start: int):
        kinds_raw = []
        for _, instr in rec:
            tag = instr & 3
            code = min(max(instr >> 2, 0), num_ops) if tag == TAG_OP else -1
            kinds_raw.append((tag, code))
        self.branch_set = tuple(sorted(set(kinds_raw)))
        index = {kc: i for i, kc in enumerate(self.branch_set)}
        self.length = len(rec)
        self.loop_start = loop_start
        self.num_ops = num_ops
        self._hist_prefix = None

        def pad(xs, fill):
            return np.asarray(list(xs) + [fill] * (TRACE_MAX - len(xs)), np.int32)

        self.pcs = pad([pc for pc, _ in rec], -1)
        self.instrs = pad([instr for _, instr in rec], 0)
        self.kinds = pad([index[kc] for kc in kinds_raw], 0)

    def __len__(self):
        return self.length

    @property
    def hist_prefix(self) -> np.ndarray:
        """``(TRACE_MAX + 1, num_ops + 4)`` int32: row ``k`` bins the first
        ``k`` recorded positions (``repro_torch.obs.metrics`` bins; recorded
        pcs are in bounds, so the invalid-pc bin never appears); rows past
        ``length`` repeat the last.  Built on first use (the obs path)."""
        if self._hist_prefix is None:
            hp = np.zeros((TRACE_MAX + 1, self.num_ops + 4), np.int32)
            for k in range(TRACE_MAX):
                hp[k + 1] = hp[k]
                if k < self.length:
                    instr = int(self.instrs[k])
                    tag = instr & 3
                    b = min(max(instr >> 2, 0), self.num_ops) if tag == TAG_OP else self.num_ops + tag
                    hp[k + 1, b] += 1
            self._hist_prefix = hp
        return self._hist_prefix


def _build_trace_fn(interp, branch_set):
    """The specialized steps of one branch set: ``run(S, tr, budget) ->
    (n_spec, guard_exit, iterations)`` runs trace ``tr`` (of this branch
    set) over the stacked state ``S`` in place.  ``n_spec`` (N,) int32
    counts each node's specialized steps, ``guard_exit`` (N,) flags nodes
    that left the path still runnable with budget to spare, and
    ``iterations`` is the host loop's count (one sync each)."""
    steps = [interp.static_step(tag, code) for tag, code in branch_set]
    CS = interp.cfg.cs_size

    def run(S, tr: _Trace, budget: int):
        cur = S.cur.long()[:, None]                  # no step switches tasks

        def running():
            return S.tstatus.gather(1, cur)[:, 0] == ST_RUN

        n = torch.zeros(S.pc.shape[0], dtype=I32, device=S.pc.device)
        alive = running()
        k = iters = 0
        while iters < budget:
            pc_k, instr_k = int(tr.pcs[k]), int(tr.instrs[k])
            # The guard: on the recorded path, and the cell still holds the
            # recorded instruction (self-modified code deopts).
            ok = (alive & (S.pc.gather(1, cur)[:, 0] == pc_k)
                  & (S.cs[:, min(max(pc_k, 0), CS - 1)] == instr_k))
            step = steps[int(tr.kinds[k])]
            groups = step.groups(S, ok)             # the step's one host sync
            if not groups:
                break
            step.run(S, groups, instr_k)
            n += ok
            alive = ok & running()
            # Past the end, re-enter at the loop point; for a path that
            # closed no loop the wrapped guard fails.
            k = tr.loop_start if k + 1 >= tr.length else k + 1
            iters += 1
        return n, (n < budget) & running(), iters

    return run


class _TraceEngine:
    """Shared per-(cfg, ISA) machinery: the recorder Oracle and two caches
    (content-keyed traces, branch-set-keyed specialized steps).  Counters
    are monotonic; frontends report deltas (``FleetVM.trace_stats()``).
    ``spec_steps_acc``/``guard_exits_acc`` are device sums, read only by
    ``TraceJitExecutor.stats()``."""

    def __init__(self, cfg: VMConfig, isa: ISA | None = None):
        self.cfg = cfg
        self.isa = isa or get_isa()
        self.interp = interp_for(cfg, isa)
        self._recorder = Oracle(cfg, isa)
        self.traces: dict = {}          # (prog_key, entry_pc, cap) -> _Trace
        self.fns: dict = {}             # branch_set -> specialized steps
        self.traces_recorded = 0
        self.traces_compiled = 0
        self.spec_steps_acc = 0
        self.guard_exits_acc = 0
        # prog_key -> {"slices", "node_slices"} (the serve monitor's view)
        self.group_stats: dict = {}

    def _record(self, st_host, cap: int) -> _Trace:
        """Run the Oracle over a host copy of one scheduled node, logging
        every fetched (pc, cell).  Recording stops at the first revisited
        pc: the path closed a loop, and the revisit's position becomes
        ``loop_start``."""
        rec: list[tuple[int, int]] = []
        seen: dict[int, int] = {}
        loop_start = 0

        class _StopTrace(Exception):
            pass

        def hook(pc, instr):
            nonlocal loop_start
            if pc in seen:
                loop_start = seen[pc]
                raise _StopTrace
            seen[pc] = len(rec)
            rec.append((pc, instr))

        oracle = self._recorder
        oracle.trace_hook = hook
        try:
            oracle.vmloop(st_host, cap)
        except _StopTrace:
            pass
        except Exception:
            # The Oracle refuses encodings the interpreter clips (negative
            # opcode payloads): keep the prefix it ran cleanly and leave the
            # rest to the generic tail.
            rec = rec[:-1]
        finally:
            oracle.trace_hook = None
        self.traces_recorded += 1
        return _Trace(rec, self.isa.num_ops, loop_start)

    def get_trace(self, prog_key, entry_pc: int, cap: int, st_host_fn) -> _Trace:
        key = (prog_key, entry_pc, cap)
        tr = self.traces.get(key)
        if tr is None:
            tr = self._record(st_host_fn(), cap)
            self.traces[key] = tr
        return tr

    def fn_for(self, branch_set):
        fn = self.fns.get(branch_set)
        if fn is None:
            fn = _build_trace_fn(self.interp, branch_set)
            self.fns[branch_set] = fn
            self.traces_compiled += 1
        return fn

    def note_group(self, prog_key, n_nodes: int) -> None:
        g = self.group_stats.setdefault(prog_key, {"slices": 0, "node_slices": 0})
        g["slices"] += 1
        g["node_slices"] += n_nodes


@functools.lru_cache(maxsize=16)
def _cached_trace_engine(cfg: VMConfig) -> _TraceEngine:
    return _TraceEngine(cfg, None)


def get_trace_engine(cfg: VMConfig, isa: ISA | None = None) -> _TraceEngine:
    """Cached for the default ISA, built fresh for a custom one."""
    if isa is None or isa is get_isa():
        return _cached_trace_engine(cfg)
    return _TraceEngine(cfg, isa)


def _no_mark(layer: str) -> None:
    pass


class TraceJitExecutor:
    """Program-specialized slice engine: ``FleetVM(executor="trace")``.

    Host-driven: each slice makes one small device-to-host probe to group
    the running nodes by program, runs each group's specialized steps, then
    one shared generic tail over every node; the state stays on the device.

    ``run_slice_batched(S, steps, mark=None) -> found`` is one slice;
    ``run_slice_exec_batched(S, quantum) -> (found, switched, preempted)``
    the Executive's micro-slice (``schedule_prio``, ``preempted`` read
    before the preempt); ``obs_schedule``/``obs_execute`` the slice split
    for the telemetry plane, the specialized steps binned in closed form
    (``trace_spec_hist``, never re-executed), the tail by the kernel's
    counting instance, ``deopts`` the guard exits.  ``mark(layer)``, when
    given, is called after each layer: "schedule", "probe", "record" (each
    recording), "spec" (each group's specialized steps), then the tail's
    "kernel" and "tail" (as ``CudaSliceExecutor``'s) and "preempt".

    ``run_slice(state, steps)`` is the single-node protocol behind
    ``REXAVM(backend="trace")``: the state is copied to ``device`` and back
    (``h2d``/``d2h`` and their bytes), its code segment hashed each call,
    so an incremental load re-keys.  With ``obs`` ``op_hist`` accumulates
    every slice's bins."""

    backend = "trace"
    host_driven = True

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, device=None, obs=None, mesh=None):
        from repro_torch.obs.metrics import n_bins, normalize_obs

        self.cfg = cfg
        self.mesh = mesh
        self.engine = get_trace_engine(cfg, isa)
        self.interp = self.engine.interp
        self.tail = CudaSliceExecutor(cfg, isa)
        self.device = device
        self._prog_keys: list | None = None
        self._key_ids: np.ndarray | None = None
        self.obs = normalize_obs(obs)
        self.op_hist = None if self.obs is None else np.zeros(n_bins(self.engine.isa), np.int64)
        self.h2d = self.d2h = self.h2d_bytes = self.d2h_bytes = 0
        self.probes = 0              # one a slice
        self.spec_passes = 0         # host iterations of specialized steps

    # -- program identity ----------------------------------------------------------

    def set_program_keys(self, keys: list) -> None:
        """Install the per-node green keys, in node order.  Stale or
        colliding keys are safe (every step re-checks the fetched cell);
        they only cost guard exits."""
        self._prog_keys = list(keys)
        self._key_ids = np.unique(np.asarray(self._prog_keys, dtype=object).astype(str),
                                  return_inverse=True)[1].reshape(-1)

    def _groups(self, run: np.ndarray, entry: np.ndarray, base: int = 0,
                total: int | None = None) -> list:
        """``[((prog_key, entry_pc), node indices)]`` of the running nodes of
        a shard holding global nodes ``base : base + N`` of ``total`` (the
        indices local to the shard), in order of each group's first node."""
        N = run.shape[0]
        keys = self._prog_keys
        if keys is None or len(keys) != (total or N):
            # No green keys: per-node identity (correct, no sharing).
            keys, ids = list(range(base, base + N)), np.arange(N)
        else:
            keys, ids = keys[base:base + N], self._key_ids[base:base + N]
        live = np.flatnonzero(run)
        if live.size == 0:
            return []
        pairs = np.stack([ids[live], entry[live].astype(np.int64)], axis=1)
        _, first, inv = np.unique(pairs, axis=0, return_index=True, return_inverse=True)
        inv = inv.reshape(-1)
        order = np.argsort(inv, kind="stable")
        members = np.split(live[order], np.cumsum(np.bincount(inv))[:-1])
        return [((keys[live[first[g]]], int(entry[live[first[g]]])), members[g])
                for g in np.argsort(first)]

    # -- slices ----------------------------------------------------------------------

    def _shards(self, S):
        """``(shard, offset, total)`` in mesh order, each shard's device
        current (a plain stacked state is one shard)."""
        if isinstance(S, vms.ShardedState) and S.mesh != self.mesh:
            raise ValueError("the state is sharded over another mesh than the engine's")
        total = len(S) if isinstance(S, vms.ShardedState) else S.pc.shape[0]
        for sh, lo in vms.each_shard(S):
            yield sh, lo, total

    def run_slice_batched(self, S, steps: int, mark=None) -> torch.Tensor:
        mark = mark or _no_mark
        found = []
        for sh, lo, total in self._shards(S):
            found.append(self.interp.schedule(sh))
            mark("schedule")
            aux = self._execute_after_schedule(sh, steps, mark, obs=self.op_hist is not None,
                                               base=lo, total=total)
            if aux is not None:
                self.op_hist += aux.op_hist.cpu().numpy()
        return vms.join_rows(found, vms.first_device(S))

    def run_slice_exec_batched(self, S, quantum: int, mark=None):
        """The Executive micro-slice: ``(found, switched, preempted)``, each
        (N,), as ``Interpreter.run_slice_exec``."""
        mark = mark or _no_mark
        out = []
        for sh, lo, total in self._shards(S):
            prev = sh.cur.clone()
            found = self.interp.schedule_prio(sh)
            switched = (found & (sh.cur != prev)).to(I32)
            mark("schedule_prio")
            preempted = self._execute_after_schedule(sh, quantum, mark, exec_mode=True,
                                                     base=lo, total=total)
            out.append((found, switched, preempted))
        return vms.join_rows(out, vms.first_device(S))

    def obs_schedule(self, S) -> torch.Tensor:
        return vms.join_rows([self.interp.schedule(sh) for sh, _, _ in self._shards(S)],
                             vms.first_device(S))

    def obs_execute(self, S, steps: int, found, mark=None):
        from repro_torch.obs.metrics import ExecAux

        auxes = [self._execute_after_schedule(sh, steps, mark or _no_mark, obs=True, base=lo,
                                              total=total)
                 for sh, lo, total in self._shards(S)]
        dev = vms.first_device(S)
        return ExecAux(*[vms.sum_to(list(xs), dev) for xs in zip(*auxes)])

    def _execute_after_schedule(self, S, steps: int, mark, obs: bool = False,
                                exec_mode: bool = False, base: int = 0, total: int | None = None):
        """Probe, group, specialized steps, generic tail, preempt, on one
        stacked state (a shard holding global nodes ``base`` on, of
        ``total``).  Returns None; with ``obs`` an ``ExecAux``; with
        ``exec_mode`` the per-node ``preempted`` flags."""
        from repro_torch.obs.metrics import n_bins, trace_spec_hist, zero_exec_aux

        eng = self.engine
        N, dev = S.pc.shape[0], S.pc.device
        nodes = torch.arange(N, device=dev)
        cur = S.cur.long()
        running = (S.tstatus[nodes, cur] == ST_RUN).to(I32)
        probe = torch.stack([running, S.pc[nodes, cur]]).cpu().numpy()     # the slice's probe
        self.probes += 1
        mark("probe")
        if obs:
            hist = torch.zeros(n_bins(eng.isa), dtype=I32, device=dev)
            deopts = torch.zeros((), dtype=I32, device=dev)
            iow0 = (S.tstatus == ST_IOWAIT).sum()
        cap = min(int(steps), TRACE_MAX)
        ns = torch.zeros(N, dtype=I32, device=dev)
        for (pkey, entry), idx in self._groups(probe[0] != 0, probe[1], base, total):
            recorded = eng.traces_recorded
            tr = eng.get_trace(pkey, entry, cap, lambda i=int(idx[0]): _host_node(S, i))
            if eng.traces_recorded != recorded:
                mark("record")
            eng.note_group(pkey, len(idx))
            if len(tr) == 0:
                continue
            fn = eng.fn_for(tr.branch_set)
            if len(idx) == N:
                # One program group holds the whole fleet: run on S itself,
                # no gather or scatter.
                n_sub, guards, iters = fn(S, tr, int(steps))
                ns = n_sub
            else:
                ia = torch.as_tensor(idx, dtype=torch.long, device=dev)
                sub = vms.take_nodes(S, ia)
                n_sub, guards, iters = fn(sub, tr, int(steps))
                vms.put_nodes(S, ia, sub)
                ns[ia] = n_sub
            self.spec_passes += iters
            eng.spec_steps_acc = _add_to(eng.spec_steps_acc, n_sub.sum(dtype=torch.int64))
            eng.guard_exits_acc = _add_to(eng.guard_exits_acc, guards.sum(dtype=torch.int64))
            mark("spec")
            if obs:
                hist += trace_spec_hist(n_sub, tr.hist_prefix, tr.length, tr.loop_start)
                deopts += guards.sum(dtype=I32)
        # The generic tail: the kernel's passes with the hand-back, at each
        # node's budget less its specialized steps.
        node_hist = torch.zeros(N, n_bins(eng.isa), dtype=I32, device=dev) if obs else None
        self.tail._execute(S, int(steps) - ns, mark, node_hist)
        preempted = self.interp.running_cur(S) if exec_mode else None
        self.interp.preempt(S)
        mark("preempt")
        if obs:
            return zero_exec_aux(eng.isa, dev)._replace(
                op_hist=hist + node_hist.sum(0, dtype=I32),
                io_susp=((S.tstatus == ST_IOWAIT).sum() - iow0).to(I32), deopts=deopts)
        return preempted

    # -- the single-node protocol (REXAVM(backend="trace")) --------------------------

    def run_slice(self, state, steps: int):
        nbytes = vms.state_nbytes(state)
        S = vms.stack1(vms.to_device(state, resolve_device(self.device)))
        if S.cs.data_ptr() == state.cs.data_ptr():
            S = vms.clone(S)
        self.h2d += 1
        self.h2d_bytes += nbytes
        keys, ids = self._prog_keys, self._key_ids
        self.set_program_keys([program_key(state.cs)])
        try:
            self.run_slice_batched(S, steps)
        finally:
            self._prog_keys, self._key_ids = keys, ids
        out = vms.unstack(vms.to_host(S), 0)
        self.d2h += 1
        self.d2h_bytes += nbytes
        return out

    # -- telemetry -----------------------------------------------------------------

    def stats(self) -> dict:
        """The engine's monotonic counters (reads the device sums)."""
        eng = self.engine
        return {
            "traces_recorded": eng.traces_recorded,
            "traces_compiled": eng.traces_compiled,
            "spec_steps": int(eng.spec_steps_acc),
            "guard_exits": int(eng.guard_exits_acc),
            "groups": {k: dict(v) for k, v in eng.group_stats.items()},
        }


def _add_to(acc, x: torch.Tensor):
    """``acc + x`` on ``acc``'s device once it is a tensor: the engine's sums
    are shared by every fleet of its VMConfig, whatever device (or shard of
    a multi-card mesh) each runs on."""
    return acc + x.to(acc.device) if isinstance(acc, torch.Tensor) else acc + x


def _host_node(S, i: int):
    """Node ``i`` of a stacked state as a single state of CPU tensors (a
    copy the recorder may run)."""
    return vms.unstack(vms.to_host(vms.take_nodes(S, [i])), 0)
