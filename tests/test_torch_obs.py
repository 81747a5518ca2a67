"""The port's telemetry plane against the JAX package's.

  * the retirement histogram over the per-opcode sweep of
    ``tests/test_torch_vmloop.py`` (every word, FIOS, the edge values):
    the port's batched, oracle and cuda engines (on the CPU the latter takes
    the kernel's plain version) against the reference's jit and oracle
    engines, bin for bin, three slices a program;
  * the counting instance's plain version (``ref.run_core(obs=True)``)
    against the reference kernel's counting instance in interpret mode;
  * ``FleetVM.metrics()`` on a messaging ring under every port executor
    against the reference's batched fleet (its counters and its key
    structure, obs on and off), the mailbox counters and the deadline
    misses against the reference fleet and ``reference_round``, the Chrome
    trace, and ``FleetServeMonitor(obs=).metrics()``.

The reference fleets all share one shape (4 nodes), one slice length (256)
and one traced round, so the JAX package compiles its obs round once.  Each framework gets its
own copy of every array.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.vm import FleetVM as JFleet
from repro.core.vm import REXAVM as JVM
from repro.core.vm import reference_round as jref_round
from repro.core.vm import vmstate as jvms
from repro.core.vm.executor import make_executor as jmake_executor
from repro.core.vm.spec import get_isa as jget_isa
from repro.kernels.vmloop import ref as jref
from repro.kernels.vmloop.vmloop import vmloop_call as jvmloop_call
from repro.obs import DeadlineMonitor as JDeadline
from repro.obs import ObsConfig as JObs
from repro.obs import RoundTracer as JTracer
from repro.obs import export_chrome_trace as jexport
from repro.obs.metrics import bin_names as jbin_names
from test_torch_fleet import ring_program
from test_torch_vmloop import (  # noqa: F401  (ref_states is a fixture)
    CFG, JCFG, PAIRS, STEPS, _jax_state, _running, ref_states,
)

from repro_torch.core.vm import FleetVM, REXAVM, make_executor, reference_round, vmstate as vms
from repro_torch.core.vm.executor import CudaSliceExecutor
from repro_torch.core.vm.spec import get_isa
from repro_torch.kernels.vmloop import check, ref as pref
from repro_torch.obs import (
    DeadlineMonitor,
    FleetMetrics,
    ObsConfig,
    RoundTracer,
    export_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.obs.metrics import bin_names, n_bins, normalize_obs

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)

N_FLEET = 4                      # every reference fleet's size (one compile)
BIN_NAMES = bin_names(get_isa())
TRACED = dict(trace=True, deadline_ms=1, deadline_wall_ms=1e9)


def _node(S, i):
    return jvms.VMState(*[np.array(np.asarray(x)[i]) for x in S])


def test_bins_equal_reference():
    assert BIN_NAMES == jbin_names(jget_isa())
    assert n_bins(get_isa()) == 103


# ---------------------------------------------------------------------------
# The full-ISA sweep: identical per-bin retirement on every engine
# ---------------------------------------------------------------------------

class _CudaOne:
    """The fleet's cuda engine over a one-node stack, counting: the
    single-node view ``run_slice(state, steps)`` with an ``op_hist``."""

    def __init__(self, cfg):
        self.ex = CudaSliceExecutor(cfg)
        self.op_hist = np.zeros(n_bins(self.ex.interp.isa), np.int64)

    def run_slice(self, state, steps):
        S = vms.stack1(vms.clone(state))
        aux = self.ex.obs_execute(S, steps, self.ex.obs_schedule(S))
        self.op_hist += aux.op_hist.numpy()
        return vms.unstack(S, 0)


@pytest.fixture(scope="module")
def obs_engines():
    port = {
        "batched": make_executor("torch", CFG, device="cpu", obs=True),
        "oracle": make_executor("oracle", CFG, device="cpu", obs=True),
        "cuda": _CudaOne(CFG),
    }
    ref = {b: jmake_executor(b, JCFG, obs=True) for b in ("jit", "oracle")}
    return port, ref


@pytest.mark.parametrize("k", range(len(PAIRS)), ids=[f"{i:03d}-{w}" for i, (w, _) in enumerate(PAIRS)])
def test_op_hist_parity_full_isa(k, ref_states, obs_engines):
    """Three slices of one sweep program: every port engine's per-bin
    counts equal the reference's jit and oracle engines', total exactly the
    retired steps, and leave the state of the reference's engine of the
    same kind (the Oracles differ from the interpreters on INT_MIN operands
    of ``/``, ``mod`` and ``pick``, in the reference as in the port)."""
    port, ref = obs_engines
    hists, finals = {}, {}
    for kind, ex in ref.items():
        h0 = ex.op_hist.copy()
        st = _node(ref_states, k)
        for _ in range(3):
            st = ex.run_slice(st, STEPS)
        hists["ref-" + kind], finals["ref-" + kind] = ex.op_hist - h0, st
    for kind, ex in port.items():
        h0 = ex.op_hist.copy()
        st = vms.from_reference(_node(ref_states, k), "cpu")
        for _ in range(3):
            st = ex.run_slice(st, STEPS)
        hists[kind], finals[kind] = ex.op_hist - h0, vms.to_reference(st)
    base = hists["ref-oracle"]
    retired = int(finals["ref-oracle"].steps) - int(_node(ref_states, k).steps)
    assert int(base.sum()) == retired > 0, PAIRS[k]
    for kind, h in hists.items():
        assert np.array_equal(h, base), (PAIRS[k], kind, {
            BIN_NAMES[i]: (int(h[i]), int(base[i])) for i in np.flatnonzero(h != base)})
        same = finals["ref-oracle" if "oracle" in kind else "ref-jit"]
        for f in jvms.VMState._fields:
            assert np.array_equal(np.asarray(getattr(finals[kind], f)),
                                  np.asarray(getattr(same, f))), (PAIRS[k], kind, f)


# ---------------------------------------------------------------------------
# The counting instance's plain version against the reference kernel's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_counting_kernel():
    return jax.jit(lambda core: jvmloop_call(core, STEPS, JCFG, interpret=True, obs=True))


def _counting_vs_reference(S_np, jax_counting_kernel, what):
    JS = _jax_state(S_np)
    jcore, n, b, o, h = jax_counting_kernel(jref.core_of(JS))
    JS = jref.merge_core(JS, jcore)
    PS = vms.from_reference(S_np, "cpu")
    _, *pout = pref.run_core(pref.core_of(PS), pref.device_tables(None, "cpu"), STEPS, CFG, obs=True)
    R = vms.to_reference(PS)
    for f in jvms.VMState._fields:
        assert np.array_equal(np.asarray(getattr(JS, f)), getattr(R, f)), (what, f)
    for name, a, p in zip(("n_exec", "bailed", "bail_op", "op_hist"), (n, b, o, h), pout):
        assert np.array_equal(np.asarray(a).astype(np.int32), p.numpy()), (what, name)
    return pout


def test_counting_plain_equals_reference_kernel_on_the_sweep(ref_states, jax_counting_kernel):
    """One slice of every sweep program (current task running) through the
    reference kernel's counting instance (Pallas, interpret mode) and the
    port's plain version: states, n_exec/bailed/bail_op and op_hist equal;
    a row's histogram totals its n_exec (the declined word is not
    binned)."""
    n, b, o, h = _counting_vs_reference(_running(ref_states), jax_counting_kernel, "sweep")
    assert torch.equal(h.sum(dim=1), n)
    assert int(b.sum()) > 0 and int(h[:, -4:].sum()) > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_counting_plain_equals_reference_kernel_on_random_states(seed, jax_counting_kernel):
    """Random bytecode and machine state (invalid pcs and reserved tags
    included) on as many nodes as the sweep."""
    S = vms.to_reference(check.random_states(CFG, len(PAIRS), seed, "cpu"))
    _counting_vs_reference(S, jax_counting_kernel, f"random {seed}")


def test_counting_plain_rows_budget_in_row_order():
    """Over a shuffled row list with per-row budgets the histograms come
    back in row order; with every budget = steps they equal the whole
    fleet's rows."""
    A = check.random_states(CFG, 40, 9, "cpu")
    B = vms.clone(A)
    tb = pref.device_tables(None, "cpu")
    _, n, _, _, whole = pref.run_core(pref.core_of(A), tb, STEPS, CFG, obs=True)
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(1)).to(torch.int32)
    _, n2, _, _, part = pref.run_core(pref.core_of(B), tb, STEPS, CFG, rows=perm,
                                      budget=torch.full((40,), STEPS, dtype=torch.int32), obs=True)
    assert torch.equal(whole[perm.long()], part) and torch.equal(n[perm.long()], n2)
    rows = torch.tensor([5, 41, -1, 0], dtype=torch.int32)
    C = check.random_states(CFG, 40, 9, "cpu")
    _, n3, _, _, h3 = pref.run_core(pref.core_of(C), tb, STEPS, CFG, rows=rows,
                                    budget=torch.tensor([3, 9, 9, 0], dtype=torch.int32), obs=True)
    assert h3.shape == (4, 103) and torch.equal(h3.sum(dim=1), n3)
    assert int(h3[1:].abs().sum()) == 0


# ---------------------------------------------------------------------------
# Fleet metrics against the reference fleet
# ---------------------------------------------------------------------------

RING = [ring_program(i, N_FLEET) for i in range(N_FLEET)]
DROP_PROGS = [
    "7 99 send 8 1 send halt",       # one dropped send, one delivered
    "receive swap drop . halt",
    "1 2 + halt",
    "halt",
]
DEADLINE_PROGS = [
    "0 begin 1+ dup 2000 >= until drop halt",
    "0 begin 1+ dup 1500 >= until drop halt",
    "1 2 + halt",                    # finishes in round 1, then idles
    "halt",
]
HANDBACK = [  # the ring with task and rnd, the words the kernel hands back
    ": w 5 0 do i drop loop ; 0 0 $ w task drop 100 rnd drop " + p if i % 2 == 0 else p
    for i, p in enumerate(RING)
]


def _port_fleet(executor, progs, obs):
    fleet = FleetVM(CFG, n=len(progs), executor=executor, device="cpu", obs=obs)
    for node, prog in zip(fleet.nodes, progs):
        node.launch(node.load(prog))
    return fleet


@functools.lru_cache(maxsize=None)
def _reference_run(progs: tuple, max_rounds: int, steps: int):
    """The reference's batched fleet with the traced obs round (compiled
    once for all 4-node fleets): (metrics dict, final states)."""
    fleet = JFleet(JCFG, n=len(progs), executor="batched", obs=JObs(**TRACED))
    for node, prog in zip(fleet.nodes, progs):
        node.launch(node.load(prog))
    fleet.run(max_rounds=max_rounds, steps=steps)
    return fleet.metrics().as_dict(), [vm.state for vm in fleet.nodes]


def _port_run(executor, progs, max_rounds, steps, **obs):
    fleet = _port_fleet(executor, progs, ObsConfig(**(obs or TRACED)))
    res = fleet.run(max_rounds=max_rounds, steps=steps)
    return fleet, res, fleet.metrics().as_dict()


SEMANTIC = ("op_retired", "instructions", "mbox_high", "mbox_drops", "io_susp", "deadline_ms",
            "deadline_miss", "deadline_miss_total", "rounds_observed")


@pytest.mark.parametrize("executor", ["batched", "cuda", "oracle"])
@pytest.mark.parametrize("workload", ["ring", "drops", "deadlines"])
def test_fleet_counters_equal_reference(executor, workload):
    """The semantic counters (every bin, mailbox high-watermark and drops,
    IO suspensions, per-node virtual-clock deadline misses, rounds) and the
    final states equal the reference fleet's."""
    progs, rounds, steps = {"ring": (RING, 16, 256), "drops": (DROP_PROGS, 6, 256),
                            "deadlines": (DEADLINE_PROGS, 12, 256)}[workload]
    jm, jstates = _reference_run(tuple(progs), rounds, steps)
    fleet, res, m = _port_run(executor, progs, rounds, steps)
    for key in SEMANTIC:
        assert m["counters"][key] == jm["counters"][key], (executor, workload, key)
    assert m["rounds"] == jm["rounds"]
    for vm, jst in zip(fleet.nodes, jstates):
        R = vms.to_reference(vm.state)
        for f in jvms.VMState._fields:
            assert np.array_equal(np.asarray(getattr(jst, f)), getattr(R, f)), (executor, f)
    c = m["counters"]
    if workload == "drops":
        assert c["mbox_drops"] == 1 and c["mbox_high"] >= 1
    if workload == "deadlines":
        assert sum(c["deadline_miss"]) > 0 and c["deadline_miss"][2] < c["deadline_miss"][0]


def test_mailbox_counters_equal_reference_round():
    """``mbox_drops``/``mbox_high`` as the reference's ``reference_round``
    accumulates them, and the port's ``reference_round`` the same."""
    ref = [JVM(JCFG, backend="oracle") for _ in DROP_PROGS]
    mine = [REXAVM(CFG, backend="oracle", device="cpu") for _ in DROP_PROGS]
    for a, b, prog in zip(ref, mine, DROP_PROGS):
        a.launch(a.load(prog))
        b.launch(b.load(prog))
    jobs, pobs = {}, {}
    for _ in range(6):
        jref_round(ref, JCFG.steps_per_slice, obs=jobs)
        reference_round(mine, CFG.steps_per_slice, obs=pobs)
    assert jobs == pobs and jobs["drops"] == 1 and jobs["depth_peak"] >= 1
    for executor in ("batched", "cuda", "oracle"):
        _, _, m = _port_run(executor, DROP_PROGS, 6, 64, time_rounds=False)
        assert m["counters"]["mbox_drops"] == jobs["drops"], executor
        assert m["counters"]["mbox_high"] == jobs["depth_peak"], executor


def test_cuda_obs_handback_equals_batched():
    """The kernel's counting passes plus the hand-backs, on a ring where
    half the nodes hand back ``task`` then ``rnd`` in one round: per bin
    the batched fleet's counts, the same final states, and ``deopts`` the
    bailed node-rounds (``kernel_stats``)."""
    fc, rc, mc = _port_run("cuda", HANDBACK, 16, 64)
    fb, rb, mb = _port_run("batched", HANDBACK, 16, 64)
    for key in SEMANTIC:
        assert mc["counters"][key] == mb["counters"][key], key
    for a, b in zip(fc.nodes, fb.nodes):
        assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))
    ks = fc.kernel_stats()
    assert mc["counters"]["deopts"] == ks["bailed_node_rounds"] > 0
    assert ks["bail_hist"] == {"task": 2, "rnd": 2} and mb["counters"]["deopts"] == 0
    assert mc["counters"]["op_retired"]["task"] == 2 and mc["counters"]["op_retired"]["rnd"] == 2
    assert mc["pallas"]["kernel_steps"] + mc["pallas"]["fallback_steps"] == mc["counters"]["instructions"]


def test_metrics_schema_equals_reference():
    """The key structure of ``metrics().as_dict()`` — every section and the
    bin names — equals the reference's, obs on and off, under every port
    executor; without obs the counters are zero."""
    jm_on, _ = _reference_run(tuple(RING), 16, 256)
    jm_off = JFleet(JCFG, n=N_FLEET).metrics().as_dict()
    for executor in ("batched", "cuda", "oracle"):
        for obs, jm in ((ObsConfig(**TRACED), jm_on), (None, jm_off)):
            fleet = _port_fleet(executor, RING, obs)
            res = fleet.run(max_rounds=16)
            m = fleet.metrics()
            assert isinstance(m, FleetMetrics)
            d = m.as_dict()
            assert set(d) == set(jm) and set(m.keys()) == set(jm)
            for section in ("counters", "latency", "pallas", "trace", "transfers", "executive"):
                assert set(d[section]) == set(jm[section]), (executor, section)
            assert set(d["counters"]["op_retired"]) == set(jm["counters"]["op_retired"])
            assert d["executive"]["enabled"] is False and d["trace"]["traces_compiled"] == 0
            assert d["rounds"] == res.rounds and d["executor"] == executor
            if obs is None:
                assert d["counters"]["instructions"] == 0 and d["counters"]["rounds_observed"] == 0
                assert d["latency"]["rounds_timed"] == 0


def test_obs_off_is_the_plain_round():
    """With obs off the fleet never builds the obs phases and leaves the
    same states as with obs on; the export is valid and empty."""
    for executor in ("batched", "cuda"):
        plain = _port_fleet(executor, HANDBACK, None)
        plain.run(max_rounds=16)
        assert plain.kernels._route_obs is None and plain._counters is None
        assert validate_chrome_trace(plain.export_trace()) == 0
        observed, _, _ = _port_run(executor, HANDBACK, 16, 64)
        for a, b in zip(plain.nodes, observed.nodes):
            assert all(torch.equal(x, y) for x, y in zip(a.state, b.state)), executor
        if executor == "cuda":
            assert plain.kernel_stats() == observed.kernel_stats()


def test_trace_export_one_span_per_phase_per_round(tmp_path):
    for executor in ("batched", "cuda", "oracle"):
        fleet, _, m = _port_run(executor, RING, 16, 64)
        path = tmp_path / f"trace_{executor}.json"
        payload = fleet.export_trace(str(path))
        n_spans = validate_chrome_trace(payload)
        assert validate_chrome_trace(str(path)) == n_spans
        rounds = m["counters"]["rounds_observed"]
        by_name: dict = {}
        for ev in payload["traceEvents"]:
            if ev.get("ph") == "X":
                by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1
                assert ev["dur"] >= 0 and "round" in ev["args"]
        for phase in ("schedule", "execute", "router", "warp"):
            assert by_name.get(phase, 0) == rounds, (executor, phase, by_name)
        assert n_spans == 4 * rounds
        assert m["latency"]["rounds_timed"] == rounds


def test_io_service_is_a_span():
    fleet = FleetVM(CFG, n=2, device="cpu", obs=ObsConfig(trace=True))
    for node in fleet.nodes:
        node.fios_add("seven", lambda: 7, args=0, ret=1)
        node.launch(node.load("seven . halt"))
    res = fleet.run(max_rounds=8)
    assert res.outputs == ["7 ", "7 "]
    assert "io_service" in [ev["name"] for ev in fleet._tracer.snapshot()]


def test_profiler_spans_carry_phase_names():
    fleet = _port_fleet("batched", RING, ObsConfig(trace=True, profiler=True))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fleet.run(max_rounds=3)
    keys = {e.key for e in prof.key_averages()}
    assert {"fleet/schedule", "fleet/execute", "fleet/router", "fleet/warp"} <= keys


# ---------------------------------------------------------------------------
# Host-side monitors, against the reference's
# ---------------------------------------------------------------------------

def test_deadline_monitor_equals_reference():
    a, b = DeadlineMonitor(deadline_wall_ms=1.0), JDeadline(deadline_wall_ms=1.0)
    for dt in (0.1, 0.5, 2.0, 8.0, 1e5, 0.003):
        a.record(dt)
        b.record(dt)
    assert a.snapshot() == b.snapshot()
    assert DeadlineMonitor().snapshot() == JDeadline().snapshot()


def test_tracer_ring_and_export_equal_reference(tmp_path):
    mine, theirs = RoundTracer(ring=8), JTracer(ring=8)
    for _ in range(50):
        for tr in (mine, theirs):
            with tr.span("execute"):
                pass
            tr.tick()
    events = mine.snapshot()
    assert len(events) == 8 and events[-1]["round"] == 49
    shared = [dict(ev) for ev in events]
    a, b = export_chrome_trace(shared, str(tmp_path / "t.json")), jexport(shared)
    assert a == b and validate_chrome_trace(a) == 8
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x"}]})
    with pytest.raises(ValueError):
        validate_chrome_trace({"nope": []})
    off = RoundTracer(enabled=False)
    with off.span("schedule"):
        pass
    assert off.snapshot() == []


def test_normalize_obs():
    assert normalize_obs(None) is None and normalize_obs(False) is None
    assert normalize_obs(True) == ObsConfig()
    cfg = ObsConfig(trace=True)
    assert normalize_obs(cfg) is cfg
    with pytest.raises(TypeError):
        normalize_obs(42)
    assert [f for f in ObsConfig.__dataclass_fields__] == [f for f in JObs.__dataclass_fields__]


def test_serve_monitor_metrics_passthrough():
    from repro.serve.vmhook import FleetServeMonitor as JMonitor

    from repro_torch.serve import FleetServeMonitor, ServeStats

    monitor = FleetServeMonitor(n=2, obs=True, device="cpu", executor="cuda")
    for step in range(1, 3):
        monitor(ServeStats(steps=step, decode_tokens=4 * step))
    d = monitor.metrics().as_dict()
    assert d["counters"]["instructions"] > 0 and d["counters"]["rounds_observed"] > 0
    assert monitor.reports()[0] == [4, 4]
    plain = FleetServeMonitor(n=1, device="cpu")
    d0 = plain.metrics().as_dict()
    jd = JMonitor(n=1).metrics().as_dict()
    assert set(d0) == set(d) == set(jd)
    for section in ("counters", "latency", "pallas", "trace", "transfers", "executive"):
        assert set(d0[section]) == set(d[section]) == set(jd[section]), section
    assert d0["counters"]["instructions"] == 0
