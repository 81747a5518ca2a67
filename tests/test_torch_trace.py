"""The port's trace-JIT (``repro_torch.core.vm.trace``) against the JAX
package's, and the single-node ``"trace"`` and ``"cuda"`` backends.

Mirrors ``tests/test_vm_trace.py`` without its sharded case:

* ``program_key`` gives the reference's hex for the same code segments;
  ``_Trace`` equals the reference recorder's (``_TraceEngine._record``)
  field for field over the opcode sweep of ``tests/test_torch_vmloop.py``
  (no XLA compile: the recorder is the plain-Python Oracle);
  ``trace_spec_hist`` equals the reference's on random step counts, loop
  wraps included;
* the opcode sweep, three slices on one node: ``"trace"`` equals
  ``"torch"``, ``"cuda"`` (the kernel's plain version on the CPU) and
  ``"oracle"``, and the JAX Oracle (except on the 16 edge-value programs
  where the Oracles differ from the interpreter, ``ORACLE_DISAGREES``;
  there the trace engine follows the interpreter);
* the deopt cases: data divergence in a shared trace, divergence inside a
  fleet group, self-modifying code on one node, a stale trace in a fleet;
  the 64-node ring against the JAX ``reference_round``; a hot
  single-program fleet (one group, > 90 % specialized); the declined-word
  fleets against ``"batched"``; ``trace_stats()`` keys under every
  executor; the re-key property (hypothesis);
* one small JAX ``FleetVM(executor="trace")`` run (its one XLA compile in
  this file): ``spec_steps``, ``guard_exits``, ``total_steps`` and the
  group's ``node_slices`` equal the port's;
* the trace fleet under ``obs=`` bins as the batched fleet does;
  ``REXAVM(backend="cuda"|"trace", device="cpu")`` over the reference's
  ``TestPallasHostIO`` programs against the Oracles, counters included.

Every comparison is byte-exact.  Each framework gets its own copy of
every array.
"""

import numpy as np
import pytest
import torch

from repro.core.vm import REXAVM as JVM
from repro.core.vm import FleetVM as JFleet
from repro.core.vm import reference_round as jref_round
from repro.core.vm import vmstate as jvms
from repro.core.vm import trace as jtrace
from repro.core.vm.oracle import Oracle as JOracle
from repro.obs import metrics as jmetrics
from test_torch_fleet import assert_equal, make_reference, ring_program
from test_torch_vmloop import CFG, JCFG, PAIRS, STEPS, ref_states  # noqa: F401  (a fixture)

from repro_torch.core.vm import (
    REXAVM,
    FleetVM,
    TraceJitExecutor,
    make_executor,
    program_key,
    vmstate as vms,
)
from repro_torch.core.vm.interp import interp_for
from repro_torch.core.vm.trace import TRACE_MAX, _TraceEngine, get_trace_engine
from repro_torch.kernels.vmloop import check
from repro_torch.obs import ObsConfig
from repro_torch.obs.metrics import trace_spec_hist

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)


def _node(S, i):
    """Node i of a stacked reference state: a single numpy state of copies."""
    return jvms.VMState(*[np.array(np.asarray(x)[i]) for x in S])


def _assert_fields(port_st, ref_st, what):
    R = vms.to_reference(port_st)
    for f in jvms.VMState._fields:
        a, b = np.asarray(getattr(ref_st, f)), getattr(R, f)
        assert np.array_equal(a, b.astype(a.dtype)), (what, f)


def _assert_port_equal(a, b, what):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), (what, f)


# The sweep programs on which the Oracle (the recorder) and the interpreter
# (and so the kernel) disagree: edge values the reference's engines treat
# differently (INT_MIN division and pick, out-of-range stores, LUT words at
# the int32 extremes; ROADMAP queue 3).  There a recorded path disagrees
# with execution, the guards stop consumption, and the trace engine ends as
# the interpreter does.
ORACLE_DISAGREES = {
    ("pick", "1 2 -2147483648 pick halt"), ("/", "-2147483648 3 / halt"),
    ("/", "5 -2147483648 / halt"), ("/", "-2147483648 -2147483648 / halt"),
    ("mod", "-2147483648 3 mod halt"), ("mod", "-7 -2147483648 mod halt"),
    ("*/", "7 5 -2147483648 */ halt"), ("!", "7 -3 ! halt"), ("!", "7 5000 ! halt"),
    ("!", "7 1060000 ! halt"), ("+!", "3 -1 +! halt"), ("log", "2147483647 log halt"),
    ("sigmoid", "-2147483648 sigmoid halt"), ("vecload", "10 2044 ! 1 0 2045 vecload halt"),
    ("vecadd", "array a { 2147483647 2 } array b { 1 5 } array s { -2 2 } array c 2 a b c s "
               "vecadd halt"),
    ("vecmap", "array a { -2147483648 900 3000 } array b 3 a b 0 0 vecmap halt"),
}


def _oracle_disagrees(finals) -> bool:
    return any(not torch.equal(x, y) for x, y in zip(finals["torch"], finals["oracle"]))


# ---------------------------------------------------------------------------
# program_key, the recorder, trace_spec_hist
# ---------------------------------------------------------------------------

def test_program_key_equals_reference(ref_states):
    keys = set()
    for k in range(len(PAIRS)):
        cs = np.array(np.asarray(ref_states.cs)[k])
        pk = program_key(torch.tensor(cs))
        assert pk == jtrace.program_key(cs) == program_key(cs.copy()), PAIRS[k]
        keys.add(pk)
    assert len(keys) == len(set(PAIRS))


@pytest.fixture(scope="module")
def recorders():
    return _TraceEngine(CFG), jtrace._TraceEngine(JCFG)


@pytest.mark.parametrize("k", range(len(PAIRS)), ids=[f"{i:03d}-{w}" for i, (w, _) in enumerate(PAIRS)])
def test_recording_equals_reference(k, ref_states, recorders):
    """The Oracle's fetch walk over one scheduled sweep node, at the
    fleet's cap and at TRACE_MAX: every field of ``_Trace`` and its
    retirement prefix table as the reference recorder's."""
    peng, jeng = recorders
    jst = _node(ref_states, k)
    JOracle(JCFG).schedule(jst)
    for cap in (STEPS, TRACE_MAX):
        pt = peng._record(vms.from_reference(jst, "cpu"), cap)
        jt = jeng._record(jvms.VMState(*[np.array(x) for x in jst]), cap)
        assert (pt.length, pt.loop_start, pt.branch_set, pt.num_ops) == \
            (jt.length, jt.loop_start, jt.branch_set, jt.num_ops), (PAIRS[k], cap)
        for f in ("pcs", "instrs", "kinds", "hist_prefix"):
            assert np.array_equal(getattr(pt, f), np.asarray(getattr(jt, f))), (PAIRS[k], cap, f)


SPEC_CASES = {
    "loop": "0 begin 1+ dup 1000 >= until drop halt",
    "nested": ": f 2 * 1+ ; 1 begin f dup 40000 > if drop 1 endif again",
    "straight": "1 2 + 3 * drop 4 5 6 + + . halt",
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_trace_spec_hist_equals_reference(case):
    """The closed form over random per-node step counts (past the path's
    end, so loop wraps are counted) equals the reference's."""
    jvm = JVM(JCFG, backend="oracle")
    jvm.launch(jvm.load(SPEC_CASES[case]))
    JOracle(JCFG).schedule(jvm.state)
    pt = _TraceEngine(CFG)._record(vms.from_reference(jvm.state, "cpu"), TRACE_MAX)
    assert pt.length > 0
    rng = np.random.default_rng(len(case))
    n = rng.integers(0, 3 * TRACE_MAX, size=24).astype(np.int32)
    if case == "straight":
        n = np.minimum(n, pt.length)              # a path without a loop is never wrapped
    import jax.numpy as jnp

    want = np.asarray(jmetrics.trace_spec_hist(jnp.array(n), np.array(pt.hist_prefix),
                                               pt.length, pt.loop_start))
    got = trace_spec_hist(torch.tensor(n), pt.hist_prefix, pt.length, pt.loop_start)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert int(got.sum()) == int(n.sum())


# ---------------------------------------------------------------------------
# Interpreter.static_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sweep", "random"])
def test_static_step_equals_one_interpreter_step(case):
    """On rows whose next cell is one instruction, ``static_step(tag,
    code)(S, rows, cell)`` equals ``vmloop(S, 1, active=rows)``: every kind
    the sweep and random node states meet over six steps, stack faults,
    reserved tags, calls and FIOS included."""
    it = interp_for(CFG)
    S = (check.sweep_states(CFG, "cpu")[1] if case == "sweep"
         else check.random_states(CFG, 96, seed=23, device="cpu"))
    kinds = set()
    for _ in range(6):
        pc_ok, tag, payload = it._fetch(S)
        cell = (payload << 2) | tag
        live = (pc_ok & it.running(S)).nonzero().flatten()
        A, B = vms.clone(S), vms.clone(S)
        for c in torch.unique(cell[live]).tolist():
            rows = live[cell[live] == c]
            t, code = c & 3, c >> 2
            it.static_step(t, code)(A, rows, c)
            kinds.add((t, min(max(code, 0), it.num_ops) if t == 0 else -1))
        mask = torch.zeros(S.pc.shape[0], dtype=torch.bool)
        mask[live] = True
        it.vmloop(B, 1, active=mask)
        assert check.max_abs_diff(A, B) == (0, []), case
        S = A
    assert len(kinds) >= 90


# ---------------------------------------------------------------------------
# The opcode sweep on one node
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def executors():
    return {b: make_executor(b, CFG, device="cpu") for b in ("trace", "torch", "cuda", "oracle")}


@pytest.mark.parametrize("k", range(len(PAIRS)), ids=[f"{i:03d}-{w}" for i, (w, _) in enumerate(PAIRS)])
def test_opcode_sweep_byte_exact(k, ref_states, executors):
    """Three slices of one sweep program on each single-node backend."""
    st0 = vms.from_reference(_node(ref_states, k), "cpu")
    finals = {}
    for backend, ex in executors.items():
        st = vms.clone(st0)
        for _ in range(3):
            st = ex.run_slice(st, STEPS)
        finals[backend] = st
    jst, jo = _node(ref_states, k), JOracle(JCFG)
    for _ in range(3):
        jst, _ = jo.run_slice(jst, STEPS)
    for backend in ("torch", "cuda"):
        _assert_port_equal(finals["trace"], finals[backend], (PAIRS[k], backend))
    if _oracle_disagrees(finals) or PAIRS[k] in ORACLE_DISAGREES:
        assert _oracle_disagrees(finals) and PAIRS[k] in ORACLE_DISAGREES, PAIRS[k]
        return
    _assert_port_equal(finals["trace"], finals["oracle"], (PAIRS[k], "oracle"))
    _assert_fields(finals["trace"], jst, (PAIRS[k], "JAX oracle"))


def test_make_executor_unknown_backend_lists_valid_names():
    with pytest.raises(ValueError) as ei:
        make_executor("bogus", CFG, device="cpu")
    for name in ("torch", "oracle", "cuda", "trace"):
        assert repr(name) in str(ei.value)


def test_fleet_unknown_executor_lists_valid_names():
    with pytest.raises(ValueError, match="'trace'"):
        FleetVM(CFG, n=2, executor="bogus", device="cpu")


# ---------------------------------------------------------------------------
# Guard failure and deoptimization
# ---------------------------------------------------------------------------

# Branches on a DIOS cell: nodes with one code segment (one program key)
# and different data take different paths.
_BRANCH_PROG = "0 v get 10 < if 1 2 + drop else 3 4 * drop endif 0 v get 1+ 0 v put 5 . halt"

# `21 $ f !` stores the encoded literal 5 over f's first cell, so later calls
# of f compute 5 + 1; the patch lands on loop iteration 3, after the loop's
# trace was recorded.
_SELFMOD_PROG = ": f 1 1 + drop ; 0 begin f 1+ dup 3 = if 21 $ f ! endif dup 6 >= until . halt"


def _dios_node(vm, v: int):
    vm.dios_add("v", np.asarray([v], np.int32))
    vm.launch(vm.load(_BRANCH_PROG))
    return vm


def _trace_fleet(progs, n=None, setup=None):
    fleet = FleetVM(CFG, n=n or len(progs), executor="trace", device="cpu")
    for i, node in enumerate(fleet.nodes):
        if setup:
            setup(i, node)
        else:
            node.launch(node.load(progs[i]))
    return fleet


def _lockstep(fleet, ref, rounds: int):
    fleet.start()
    for _ in range(rounds):
        fleet.kernels.round(fleet._S, STEPS)
    fleet.sync()
    for _ in range(rounds):
        jref_round(ref, JCFG.steps_per_slice)


def test_shared_trace_data_divergence():
    """One program, two data environments: the second node reuses the
    first's trace, fails the branch guard and deoptimizes, and still
    equals the JAX Oracle byte for byte."""
    ex = TraceJitExecutor(CFG, device="cpu")
    guards0 = ex.stats()["guard_exits"]
    for v in (0, 100):              # records the v < 10 path, then diverges
        st = _dios_node(REXAVM(CFG, backend="oracle", device="cpu"), v).state
        jst = _dios_node(JVM(JCFG, backend="oracle"), v).state
        jo = JOracle(JCFG)
        for _ in range(2):
            st = ex.run_slice(st, STEPS)
            jst, _ = jo.run_slice(jst, STEPS)
        _assert_fields(st, jst, v)
    assert ex.stats()["guard_exits"] > guards0


def test_group_divergence_in_fleet():
    """Four nodes share one program (one group, one trace) but their data
    send them down different branches: byte-exact with reference_round."""
    def setup(i, vm):
        _dios_node(vm, i * 50)

    fleet = _trace_fleet(None, n=4, setup=setup)
    ref = [_dios_node(JVM(JCFG, backend="oracle", seed=1 + i), i * 50) for i in range(4)]
    guards0 = fleet.kernels.executor.stats()["guard_exits"]
    _lockstep(fleet, ref, 4)
    assert_equal(fleet, ref)
    assert fleet.kernels.executor.stats()["guard_exits"] > guards0
    assert len(set(fleet.kernels.executor._prog_keys)) == 1


def test_self_modifying_code_single_node():
    """The single-node protocol re-hashes the code segment every slice, so
    the patch re-keys the cache; byte-exact with the Oracles."""
    vt, vo = REXAVM(CFG, backend="trace", device="cpu"), JVM(JCFG, backend="oracle")
    rt = vt.run(vt.load(_SELFMOD_PROG), max_slices=200, steps=8)
    ro = vo.run(vo.load(_SELFMOD_PROG), max_slices=200, steps=8)
    assert rt.status == ro.status == "halt" and rt.output == ro.output
    _assert_fields(vt.state, vo.state, "selfmod")
    assert vt.executor.h2d == vt.executor.d2h == rt.slices


def test_self_modifying_code_fleet_stale_trace():
    """In a fleet the keys freeze at start(), so the patch leaves the cached
    loop trace stale: the per-cell guard exits and the run stays byte-exact
    with reference_round."""
    fleet, ref = _trace_fleet([_SELFMOD_PROG]), make_reference([_SELFMOD_PROG])
    guards0 = fleet.kernels.executor.stats()["guard_exits"]
    _lockstep(fleet, ref, 6)
    assert_equal(fleet, ref)
    assert fleet.kernels.executor.stats()["guard_exits"] > guards0


# ---------------------------------------------------------------------------
# Fleets
# ---------------------------------------------------------------------------

def test_64_node_ring_equals_reference():
    """The 64-node ring (64 programs: per-group gathers and scatters),
    state resident on the device between one transfer each way."""
    n = 64
    progs = [ring_program(i, n) for i in range(n)]
    fleet = _trace_fleet(progs)
    res = fleet.run(max_rounds=300)
    assert fleet.h2d == 1 and fleet.d2h == 1
    assert res.statuses == ["halt"] * n and res.outputs[0] == f"{n - 1} {n} "
    stats = fleet.trace_stats()
    assert stats["executor"] == "trace" and stats["traces_recorded"] > 0 and stats["spec_steps"] > 0
    ref = make_reference(progs)
    for _ in range(res.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal(fleet, ref, skip=("out", "outp"))       # run() drained the rings
    assert res.outputs == [vm.output() for vm in ref]
    assert fleet.kernel_stats()["kernel_steps"] == 0


HOT = ": w 0 begin 1+ dup 600 >= until drop ; w w halt"


def test_hot_single_program_fleet_specializes():
    """One program on every node: one group, grown by whole fleets (the
    full-fleet path), more than 90 % of the instructions specialized."""
    n = 8
    fleet = _trace_fleet([HOT] * n)
    eng = fleet.kernels.executor.engine
    before = {k: v["node_slices"] for k, v in eng.group_stats.items()}
    res = fleet.run(max_rounds=400)
    assert res.statuses == ["halt"] * n
    stats = fleet.trace_stats()
    assert stats["specialized_frac"] > 0.9, stats
    assert stats["guard_exits"] <= stats["total_steps"] == int(res.steps.sum())
    grown = {k: v["node_slices"] - before.get(k, 0) for k, v in eng.group_stats.items()
             if v["node_slices"] != before.get(k, 0)}
    assert len(grown) == 1 and next(iter(grown.values())) % n == 0, grown


HANDBACK = {
    "task_then_rnd": ": w 3 . end ; 0 0 $ w task drop 7 rnd . halt",
    "rnd_loop": "0 12 0 do 5 rnd + 1+ loop . halt",
    "fios_call": "seven 1+ . seven . halt",
    "exception": ": h 42 . ; $ h exception divbyzero catch 0= if 7 rnd 0 / drop endif 1 . halt",
}


@pytest.mark.parametrize("case", sorted(HANDBACK))
def test_declined_words_equal_batched(case):
    """Words the kernel declines run as specialized steps; with host IO
    and exceptions the trace fleet ends as the batched one."""
    out = {}
    for executor in ("trace", "batched"):
        fleet = FleetVM(CFG, n=3, executor=executor, device="cpu")
        for node in fleet.nodes:
            node.svc_add("seven", lambda: 7, args=0, ret=1)
            node.launch(node.load(HANDBACK[case]))
        res = fleet.run(max_rounds=60)
        assert res.statuses == ["halt"] * 3
        out[executor] = (fleet, res)
    (ft, rt), (fb, rb) = out["trace"], out["batched"]
    assert rt.rounds == rb.rounds and rt.outputs == rb.outputs
    for a, b in zip(ft.nodes, fb.nodes):
        _assert_port_equal(a.state, b.state, case)
    assert ft.trace_stats()["spec_steps"] > 0


def test_trace_stats_keys_under_every_executor():
    keys = set(FleetVM(CFG, n=2, executor="trace", device="cpu").trace_stats())
    for executor in ("batched", "cuda", "oracle", "auto"):
        stats = FleetVM(CFG, n=2, executor=executor, device="cpu").trace_stats()
        assert set(stats) == keys and stats["spec_steps"] == 0 and stats["groups"] == {}
    assert keys == set(JFleet(JCFG, n=1).trace_stats())
    m = FleetVM(CFG, n=2, executor="trace", device="cpu").metrics().as_dict()
    assert set(m["trace"]) == keys - {"executor"}


# ---------------------------------------------------------------------------
# Program mutation re-keys the trace cache (hypothesis)
# ---------------------------------------------------------------------------

_MUTATION_PROGRAMS = [
    "0 10 0 do 1+ loop . halt",
    "1 5 0 do dup + loop . halt",
    ": f 2 * ; 3 f f . halt",
    "7 . 42 . halt",
]


def _mutation_case(extra: str, rounds_before: int, rounds_after: int):
    base = [f"{i} . 0 8 0 do 1+ loop . halt" for i in range(3)]
    fleet, ref = _trace_fleet(base), make_reference(base)
    _lockstep(fleet, ref, rounds_before)
    assert_equal(fleet, ref)
    ex = fleet.kernels.executor
    old = program_key(fleet.nodes[1].state.cs)
    assert ex._prog_keys[1] == old
    for vm in (fleet.nodes[1], ref[1]):
        vm.launch(vm.load(extra))
    new = program_key(fleet.nodes[1].state.cs)
    assert new != old
    _lockstep(fleet, ref, rounds_after)             # start() re-keys
    assert_equal(fleet, ref)
    assert ex._prog_keys[1] == new and any(k[0] == new for k in ex.engine.traces)


def test_program_mutation_rekeys_trace_cache():
    _mutation_case(_MUTATION_PROGRAMS[0], rounds_before=2, rounds_after=4)


try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=4, deadline=None)
    @given(prog=st.sampled_from(_MUTATION_PROGRAMS), rounds_before=st.integers(1, 3),
           rounds_after=st.integers(1, 4))
    def test_program_mutation_property(prog, rounds_before, rounds_after):
        """Any incremental load re-keys the node's entry and the fleet
        stays byte-exact with reference_round."""
        _mutation_case(prog, rounds_before, rounds_after)
except ImportError:      # pragma: no cover - hypothesis is installed
    pass


# ---------------------------------------------------------------------------
# The JAX trace fleet's counters
# ---------------------------------------------------------------------------

# One code segment, data-dependent loop exits (guard exits), and a second
# program in its own group.
COUNTED = ["0 begin 1+ dup 0 v get >= until . halt"] * 3 + [": w 0 begin 1+ dup 90 >= until ; w . halt"]


def _counted_fleet(fleet_cls, cfg, **kw):
    fleet = fleet_cls(cfg, n=len(COUNTED), executor="trace", **kw)
    for i, (node, prog) in enumerate(zip(fleet.nodes, COUNTED)):
        node.dios_add("v", np.asarray([40 + 17 * i], np.int32))
        node.launch(node.load(prog))
    return fleet


def _run_counted(fleet, groups):
    before = {k: v["node_slices"] for k, v in groups().items()}
    res = fleet.run(max_rounds=80)
    grown = {k: v["node_slices"] - before.get(k, 0) for k, v in groups().items()
             if v["node_slices"] != before.get(k, 0)}
    return res, fleet.trace_stats(), grown


def test_counters_equal_jax_trace_fleet():
    """The same fleet through the JAX trace engine (compiled once) and the
    port's: states, outputs, and the specialized steps, guard exits, total
    steps and each group's node-slices, delta for delta."""
    jf = _counted_fleet(JFleet, JCFG)
    jr, js, jg = _run_counted(jf, lambda: jf.kernels.executor.engine.group_stats)
    pf = _counted_fleet(FleetVM, CFG, device="cpu")
    pr, ps, pg = _run_counted(pf, lambda: pf.kernels.executor.engine.group_stats)
    assert pr.statuses == jr.statuses == ["halt"] * len(COUNTED)
    assert pr.rounds == jr.rounds and pr.outputs == jr.outputs
    assert_equal(pf, jf.nodes)
    for key in ("spec_steps", "guard_exits", "total_steps", "specialized_frac"):
        assert ps[key] == js[key], key
    assert ps["guard_exits"] > 0 and pg == jg


# ---------------------------------------------------------------------------
# Telemetry and the single-node backends
# ---------------------------------------------------------------------------

def test_trace_fleet_obs_bins_as_batched():
    """With obs the specialized steps are binned in closed form and the
    tail by the kernel's counting path: op_retired equals the batched
    fleet's bin for bin; deopts are the guard exits."""
    progs = COUNTED[1:] + [HANDBACK["rnd_loop"], ring_program(0, 1)]
    out = {}
    for executor in ("trace", "batched"):
        fleet = FleetVM(CFG, n=len(progs), executor=executor, device="cpu", obs=ObsConfig())
        for i, (node, prog) in enumerate(zip(fleet.nodes, progs)):
            node.dios_add("v", np.asarray([30 + i], np.int32))
            node.launch(node.load(prog))
        res = fleet.run(max_rounds=60)
        out[executor] = (fleet, res, fleet.metrics().as_dict())
    (ft, rt, mt), (fb, rb, mb) = out["trace"], out["batched"]
    assert rt.rounds == rb.rounds and rt.outputs == rb.outputs
    for a, b in zip(ft.nodes, fb.nodes):
        _assert_port_equal(a.state, b.state, "obs")
    for key in ("op_retired", "instructions", "io_susp", "mbox_high", "mbox_drops",
                "rounds_observed"):
        assert mt["counters"][key] == mb["counters"][key], key
    assert mt["counters"]["instructions"] == int(rt.steps.sum())
    assert mt["counters"]["deopts"] == ft.trace_stats()["guard_exits"] > 0
    assert mt["trace"]["spec_steps"] > 0 and mt["pallas"]["kernel_steps"] == 0


def test_single_node_trace_obs_counts_as_torch():
    prog = "0 40 0 do 3 rnd + loop . halt"
    hist = {}
    for backend in ("trace", "torch", "cuda"):
        vm = REXAVM(CFG, backend=backend, device="cpu")
        vm.executor = make_executor(backend, CFG, device="cpu", obs=True)
        vm.run(vm.load(prog), max_slices=20)
        hist[backend] = vm.executor.op_hist
    assert hist["trace"].sum() > 0
    assert np.array_equal(hist["trace"], hist["torch"]) and np.array_equal(hist["cuda"], hist["torch"])


def _host_io_pair(backend, prog, fios=False):
    pv, jv = REXAVM(CFG, backend=backend, device="cpu"), JVM(JCFG, backend="oracle")
    if fios:
        for vm in (pv, jv):
            vm.svc_add("seven", lambda: 7, args=0, ret=1)
    rp, rj = pv.run(pv.load(prog), max_slices=100), jv.run(jv.load(prog), max_slices=100)
    assert (rp.status, rp.output, rp.steps) == (rj.status, rj.output, rj.steps)
    _assert_fields(pv.state, jv.state, (backend, prog))
    assert pv.out_stream == jv.out_stream
    return pv.executor, rp


@pytest.mark.parametrize("backend", ["cuda", "trace"])
def test_host_io_mid_slice_out(backend):
    ex, res = _host_io_pair(backend, "0 30 0 do 1+ loop out halt")
    assert res.status == "halt" and ex.h2d == ex.d2h == res.slices
    if backend == "cuda":
        assert ex.bailouts == 0 and ex.bail_hist == {} and ex.kernel_steps == res.steps


@pytest.mark.parametrize("backend", ["cuda", "trace"])
def test_host_io_fios_call(backend):
    ex, res = _host_io_pair(backend, "seven 1+ halt", fios=True)
    assert res.status == "halt"
    if backend == "cuda":
        assert ex.bailouts >= 1 and ex.bail_hist.get("fios/trap", 0) >= 1
        assert ex.kernel_steps + ex.fallback_steps == res.steps


@pytest.mark.parametrize("backend", ["cuda", "trace"])
def test_host_io_multitask_sleep_await(backend):
    ex, res = _host_io_pair(backend, "var flag : w 1 flag ! end ; "
                                     "0 0 $ w task drop 100 1 flag await . flag @ . halt")
    if backend == "cuda":
        assert ex.bail_hist.get("task", 0) >= 1 and ex.kernel_steps > 0


def test_engine_is_shared_per_config():
    """One engine a VMConfig for the default ISA (as ``interp_for``), a
    fresh one for a custom ISA."""
    from repro_torch.core.vm.spec import ISA, WORDS

    assert get_trace_engine(CFG) is get_trace_engine(CFG)
    assert TraceJitExecutor(CFG).engine is make_executor("trace", CFG, device="cpu").engine
    assert get_trace_engine(CFG, ISA(list(WORDS))) is not get_trace_engine(CFG)
