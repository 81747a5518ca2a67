"""The port's Auditor (``repro_torch.analysis``) and ``FleetVM(executor=
"auto")`` against the JAX package's, and vmloop's checks-elided instance.

* the verifier's ``ProgramReport`` equals the reference's field for field
  (verdict, WCET, words, branch-set kinds, every entry, every diagnostic
  string) over the reference test's programs, the examples, both rings of
  ``chip_smoke.py`` phase 4e, the vmloop sweep and 25 corrupted programs;
  so do ``bail_words``, ``predict_branch_set(s)`` and ``plan_backend``
  (the port's ``"cuda"`` where the reference says ``"pallas"``), and the
  CLI's report;
* ``FleetVM(executor="auto", device="cpu")``: a verified fleet runs the
  checks-elided engine byte for byte against both ``reference_round``s;
  errors run checked ``batched``; a trace plan runs the trace-JIT with its
  branch sets built at ``start()``; ``push()`` plans again; the predicted bail-out words are the observed ``bail_hist`` keys;
* the kernel's checks-elided instance, built for the CPU with g++
  (``run_core<false, true>``), equals its plain version on the sweep and
  on random states, and on the verified sweep the reference's
  ``make_run_core(elide_checks=True)``;
* a hypothesis property: the port's elided and checked interpreters and
  the reference's elided interpreter agree on well-formed programs.

Two JAX functions are compiled here, once each: the vmapped elided
``run_core`` and the reference's elided interpreter.  The reference's
verifier and ``reference_round`` over Oracle nodes compile nothing.
"""

import importlib.util
import json
import os
import pathlib
import random
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import analyze_program as j_analyze_program
from repro.analysis import analyze_source as j_analyze_source
from repro.analysis import analyze_vm as j_analyze_vm
from repro.analysis import bail_words as j_bail_words
from repro.analysis import cli as jcli
from repro.analysis import plan_backend as j_plan_backend
from repro.analysis.feasibility import predict_branch_sets as j_predict_branch_sets
from repro.config import VMConfig as JCfg
from repro.core.vm import REXAVM as JVM
from repro.core.vm import reference_round as jref_round
from repro.core.vm import vmstate as jvms
from repro.core.vm.interp import get_interpreter as j_get_interpreter
from repro.kernels.vmloop import ref as jref
from test_torch_vmloop import _build_host

from repro_torch.analysis import (
    VERIFIED,
    analyze_program,
    analyze_source,
    analyze_vm,
    bail_words,
    cli,
    plan_backend,
    predict_branch_set,
    predict_branch_sets,
)
from repro_torch.config import VMConfig
from repro_torch.core.vm import REXAVM, FleetVM, reference_round, vmstate as vms
from repro_torch.core.vm.interp import interp_for
from repro_torch.core.vm.spec import EXC_STACK, ST_ERR, ST_HALT
from repro_torch.kernels.vmloop import check, ref as pref, vmloop as kmod

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4)
JCFG = JCfg(cs_size=2048, steps_per_slice=64, mbox_size=4)
STEPS = CFG.steps_per_slice
CONFIGS = {"small": (CFG, JCFG), "default": (VMConfig(), JCfg())}

CLEAN = ": work 1 2 + 3 * drop ; work halt"
LOOPED = ": work 0 10 0 do i + loop drop ; work halt"
SPIN_RND = ": spin begin 1 rnd drop again ; spin"
UNDERFLOW = ": bad + ; bad halt"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ann_program = _chip_smoke().ann_program

# name -> (program, config): the reference test's programs, the examples,
# and nodes 0 and 1 of phase 4e's two 4096-node rings at VMConfig().
PROGRAMS = {
    "clean": (CLEAN, "small"),
    "looped": (LOOPED, "small"),
    "spin_rnd": (SPIN_RND, "small"),
    "underflow": (UNDERFLOW, "small"),
    "overflow": (" ".join(["1"] * (CFG.ds_size + 8)) + " halt", "small"),
    "loop10": (": w 0 10 0 do 1 + loop drop ; w halt", "small"),
    "loop100": (": w 0 100 0 do 1 + loop drop ; w halt", "small"),
    "unbounded": (": w begin 1 drop again ; w", "small"),
    "dynamic_exec": ("steps exec halt", "small"),
    "recursive": (": f f ; f halt", "small"),
    **{f"example_{p.stem}": (p.read_text(), "small")
       for p in sorted((ROOT / "examples" / "programs").glob("*.f4"))},
    **{f"ring_{i}": (ann_program(i, 4096, spawners=False), "default") for i in (0, 1)},
    **{f"ring_spawners_{i}": (ann_program(i, 4096), "default") for i in (0, 16)},
}


def report_fields(rep) -> dict:
    """Every field of a ProgramReport, diagnostics as their strings."""
    return {
        "verdict": rep.verdict, "wcet": rep.wcet, "words": sorted(rep.words),
        "kinds": sorted(rep.kinds), "has_fios": rep.has_fios,
        "entries": [(e.pc, e.function, e.verdict, e.wcet, e.max_ds, e.max_fs, e.rs_need,
                     e.returns, [str(d) for d in e.diagnostics]) for e in rep.entries],
        "diagnostics": [str(d) for d in rep.diagnostics],
    }


def node_pair(text: str, config: str = "small", fios: bool = False):
    """The program compiled on a port node and a reference Oracle node:
    ``(vm, frame, jvm, jframe)``; ``fios`` registers ``seven`` first."""
    pcfg, jcfg = CONFIGS[config]
    vm, jvm = REXAVM(pcfg, device="cpu"), JVM(jcfg, backend="oracle")
    if fios:
        vm.fios_add("seven", lambda: 7, args=0, ret=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jvm.fios_add("seven", lambda: 7, args=0, ret=1)
    return vm, vm.load(text), jvm, jvm.load(text)


def outcome(fn, *args, **kw):
    """``fn(*args, **kw)``, or the name of the exception it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — compared as a value
        return type(e).__name__


def assert_same_analysis(vm, frame, jvm, jframe):
    """analyze_vm, bail_words and the branch sets from the launch entry.
    Where the reference's verifier raises (a constant ``exec`` target
    outside the code segment is decoded), the port raises the same."""
    entry = [(frame.entry, 0, 0, 0, 0)]
    assert frame.entry == jframe.entry
    rep, jrep = outcome(analyze_vm, vm, entries=entry), outcome(j_analyze_vm, jvm, entries=entry)
    if isinstance(jrep, str):
        assert rep == jrep
        return None
    assert report_fields(rep) == report_fields(jrep)
    assert bail_words(rep) == j_bail_words(jrep)
    cs = vm.state.cs.numpy()
    assert predict_branch_sets(cs, frame.entry, vm.isa) == j_predict_branch_sets(
        np.asarray(jvm.state.cs), frame.entry, jvm.isa)
    return rep


# ---------------------------------------------------------------------------
# The verifier and the feasibility pass against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PROGRAMS))
def test_report_equals_reference(name):
    text, config = PROGRAMS[name]
    pcfg, jcfg = CONFIGS[config]
    rep = analyze_source(text, pcfg)
    assert report_fields(rep) == report_fields(j_analyze_source(text, jcfg))
    assert_same_analysis(*node_pair(text, config))
    if name == "clean":
        assert rep.verdict == VERIFIED and rep.wcet > 0
    if name == "loop100":
        assert rep.wcet > analyze_source(PROGRAMS["loop10"][0], pcfg).wcet >= 10


def test_sweep_reports_equal_reference():
    """Every program of the vmloop sweep (all 99 words, edge values and a
    FIOS call), verified from its launch entry with the node's syscall
    arities; most verify, and the ones that provably fault do not."""
    verdicts = {}
    for word, prog in check.sweep_programs(CFG):
        rep = assert_same_analysis(*node_pair(prog, fios=word == "fios/trap"))
        key = rep.verdict if rep is not None else "raised"
        verdicts[key] = verdicts.get(key, 0) + 1
    assert verdicts[VERIFIED] > 100 and verdicts.get("error", 0) > 0, verdicts
    assert verdicts.get("raised", 0) == 1, verdicts          # "99999 exec halt"


def test_corrupted_call_target_is_error_as_in_reference():
    vm, frame, jvm, jframe = node_pair(CLEAN)
    cs = vm.state.cs.numpy().copy()
    cs[frame.entry] = ((CFG.cs_size + 100) << 2) | 2          # TAG_CALL out of bounds
    rep = analyze_program(cs, [frame.entry], vm.isa, CFG)
    assert rep.verdict == "error"
    assert report_fields(rep) == report_fields(
        j_analyze_program(cs.copy(), [jframe.entry], jvm.isa, JCFG))


def _corruption_case(idx: int, value: int) -> None:
    """One code cell of CLEAN overwritten: the port's report equals the
    reference's, and when it verifies the checked Oracle never raises
    EXC_STACK (the fault the elided engines stop checking for)."""
    _, _, jvm, jframe = node_pair(CLEAN)
    vm = REXAVM(CFG, backend="oracle", device="cpu")
    frame = vm.load(CLEAN)
    pc = frame.start + idx % max(frame.end - frame.start, 1)
    vm.state.cs[pc] = value
    rep = analyze_program(vm.state.cs.numpy(), [frame.entry], vm.isa, CFG)
    jcs = np.asarray(jvm.state.cs).copy()
    jcs[pc] = np.int32(value)
    assert report_fields(rep) == report_fields(
        j_analyze_program(jcs, [jframe.entry], jvm.isa, JCFG))
    if rep.verdict != VERIFIED:
        return                     # caught (error) or sent to the checked path (flagged)
    vm.launch(frame)
    vm.run(max_slices=20, steps=STEPS)
    st = vm.state
    assert not (int(st.tstatus[0]) == ST_ERR and int(st.last_exc[0]) == EXC_STACK), (pc, value)


def test_single_cell_corruption_caught_or_harmless():
    """The reference test's 25 deterministic corruptions (random.Random(0))."""
    rng = random.Random(0)
    for _ in range(25):
        _corruption_case(rng.randrange(0, 64), rng.randrange(-(2 ** 31), 2 ** 31))


def _plan_inputs(progs, config, analyze, predict):
    """(reports, branch sets) as FleetVM._resolve_auto builds them, from
    launched nodes' live entries."""
    reports, sets = [], []
    for text in progs:
        vm, frame, jvm, jframe = node_pair(text, config)
        vm.launch(frame)
        jvm.launch(jframe)
        node = vm if analyze is analyze_vm else jvm
        rep = analyze(node)
        cs = node.state.cs.numpy() if node is vm else np.asarray(node.state.cs)
        s = predict(cs, rep.entries[0].pc, node.isa) if rep.entries else ()
        reports.append(rep)
        sets.append(s[0] if s else None)
    return reports, sets


PLANS = {
    "clean": ([CLEAN] * 4, "small", ("cuda", True)),
    "verified_mix": ([CLEAN, LOOPED, PROGRAMS["loop100"][0]], "small", ("cuda", True)),
    "underflow": ([UNDERFLOW, CLEAN], "small", ("batched", False)),
    "spin_rnd": ([SPIN_RND] * 2, "small", ("trace", False)),
    "flagged": (["steps exec halt", CLEAN], "small", ("cuda", False)),
    "ring": ([ann_program(i, 32, spawners=False) for i in range(32)], "default", ("cuda", True)),
    "ring_spawners": ([ann_program(i, 32) for i in range(32)], "default", ("batched", True)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_equals_reference(case):
    """plan_backend over a fleet's reports and entry branch sets: the
    reference's plan with ``pallas`` read as ``cuda``, reasons included."""
    progs, config, want = PLANS[case]
    plan = plan_backend(*_plan_inputs(progs, config, analyze_vm, predict_branch_sets))
    jplan = j_plan_backend(*_plan_inputs(progs, config, j_analyze_vm, j_predict_branch_sets))
    port = {"pallas": "cuda"}
    assert (plan.executor, plan.elide_checks) == want
    assert plan.executor == port.get(jplan.executor, jplan.executor)
    assert plan.elide_checks == jplan.elide_checks
    assert plan.reasons == [r.replace("pallas", "cuda") for r in jplan.reasons]
    assert plan.bail_words == jplan.bail_words and plan.branch_sets == jplan.branch_sets


def test_predict_branch_set_on_straight_line_code():
    vm, frame, jvm, jframe = node_pair(CLEAN)
    bs = predict_branch_set(vm.state.cs.numpy(), frame.entry, vm.isa)
    assert bs and all(isinstance(k, tuple) and len(k) == 2 for k in bs)


def test_cli_report_equals_reference(tmp_path, monkeypatch, capsys):
    """The CLI's --json report and its printed lines over
    examples/programs, for verify and lint --strict."""
    monkeypatch.chdir(ROOT)
    for argv in (["verify"], ["lint", "--strict"]):
        out = {}
        for name, main in (("port", cli.main), ("reference", jcli.main)):
            path = tmp_path / f"{name}.json"
            rc = main(argv + ["--json", str(path), "examples/programs"])
            out[name] = (rc, json.loads(path.read_text()), capsys.readouterr().out)
        assert out["port"] == out["reference"]
        assert len(out["port"][1]["reports"]) == 4


def test_cli_runs_without_jax_or_the_reference():
    """``python -m repro_torch.analysis verify examples/programs`` on a
    host with no GPU, importing neither JAX nor the JAX package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['repro_torch.analysis', 'verify', 'examples/programs']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('IMPORTED', bad)\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED []" in r.stdout and "4 program(s), 0 failed" in r.stdout


# ---------------------------------------------------------------------------
# FleetVM(executor="auto") on the CPU
# ---------------------------------------------------------------------------

def make_fleet(progs, executor, cfg=CFG, **kw):
    fleet = FleetVM(cfg, n=len(progs), executor=executor, device="cpu", **kw)
    for node, prog in zip(fleet.nodes, progs):
        node.launch(node.load(prog))
    return fleet


@pytest.fixture
def run_core_calls(monkeypatch):
    """Every call of the kernel's plain version through vmloop_call (the
    CPU side of each launch), as (obs, elide_checks)."""
    calls = []
    real = kmod.run_core

    def spy(*args, obs=False, elide_checks=False, **kw):
        calls.append((obs, elide_checks))
        return real(*args, obs=obs, elide_checks=elide_checks, **kw)

    monkeypatch.setattr(kmod, "run_core", spy)
    return calls


AUTO_PROGS = [": w 0 10 0 do i + loop . ; w halt", ": w 1 2 + 3 * dup . drop ; w halt",
              CLEAN, LOOPED]


def test_auto_verified_fleet_is_byte_exact_with_both_reference_rounds(run_core_calls):
    """A verified fleet plans the kernel with the checks elided; its rounds
    (every one through the elided plain version) equal the port's
    reference_round and the reference's, field for field."""
    fleet = make_fleet(AUTO_PROGS, "auto")
    fleet.start()
    a = fleet.analysis_stats()
    assert (a["executor"], a["elide_checks"], a["requested"], a["auto"]) == ("cuda", True, "auto", True)
    assert a["verdicts"] == {"verified": 4, "flagged": 0, "error": 0}
    assert a["predicted_bail_words"] == [] and all(w is not None for w in a["wcet"])
    assert fleet.kernels.executor.interp.elide_checks
    pnodes = [REXAVM(CFG, seed=1 + i, device="cpu") for i in range(4)]
    jnodes = [JVM(JCFG, backend="oracle", seed=1 + i) for i in range(4)]
    for vm, jvm, prog in zip(pnodes, jnodes, AUTO_PROGS):
        vm.launch(vm.load(prog))
        jvm.launch(jvm.load(prog))
    for _ in range(6):
        fleet.kernels.round(fleet._S, STEPS)
        reference_round(pnodes, STEPS)
        jref_round(jnodes, STEPS)
    fleet.sync()
    assert run_core_calls and set(run_core_calls) == {(False, True)}
    for node, pn, jn in zip(fleet.nodes, pnodes, jnodes):
        assert check.max_abs_diff(node.state, pn.state) == (0, [])
        ref = vms.to_reference(node.state)
        for f in jvms.VMState._fields:
            assert np.array_equal(getattr(ref, f), np.asarray(getattr(jn.state, f))), f
    assert int(fleet.nodes[0].state.tstatus[0]) == ST_HALT
    assert fleet.kernel_stats()["bail_hist"] == {}


def test_auto_clean_fleet_runs_elided_to_halt():
    fleet = make_fleet([CLEAN] * 4, "auto")
    res = fleet.run(max_rounds=8)
    assert res.statuses == ["halt"] * 4
    assert (fleet.executor_kind, fleet.analysis_stats()["elide_checks"]) == ("cuda", True)


def test_auto_error_fleet_runs_checked_batched():
    fleet = make_fleet([UNDERFLOW], "auto")
    fleet.run(max_rounds=4)
    a = fleet.analysis_stats()
    assert (a["executor"], a["elide_checks"]) == ("batched", False)
    assert a["verdicts"]["error"] == 1 and any("underflow" in d for d in a["diagnostics"])
    assert not fleet.kernels.executor.interp.elide_checks
    st = fleet.nodes[0].state
    assert int(st.tstatus[0]) == ST_ERR and int(st.last_exc[0]) == EXC_STACK


def test_auto_trace_plan_runs_on_the_trace_engine():
    """Single-path programs with a declined word plan the trace-JIT: both
    predicted branch sets of each node (entry path, steady loop) are built
    at start(), nothing is built during 4 rounds, and the fleet ends byte
    for byte as executor="batched" and the reference's reference_round."""
    fleet = make_fleet([SPIN_RND] * 2, "auto")
    fleet.start()
    a = fleet.analysis_stats()
    assert (a["executor"], a["elide_checks"]) == ("trace", False) == (fleet.executor_kind, False)
    assert a["predicted_bail_words"] == ["rnd"] and a["aot_branch_sets"] == 2
    eng = fleet.kernels.executor.engine
    sets = predict_branch_sets(fleet.nodes[0].state.cs.numpy(), fleet._node_reports[0].entries[0].pc)
    assert len(sets) == 2 and all(bs in eng.fns for bs in sets)
    compiled = eng.traces_compiled
    batched = make_fleet([SPIN_RND] * 2, "batched")
    batched.start()
    jnodes = [JVM(JCFG, backend="oracle", seed=1 + i) for i in range(2)]
    for jvm in jnodes:
        jvm.launch(jvm.load(SPIN_RND))
    for _ in range(4):
        fleet.kernels.round(fleet._S, STEPS)
        batched.kernels.round(batched._S, STEPS)
        jref_round(jnodes, STEPS)
    fleet.sync()
    batched.sync()
    assert eng.traces_compiled == compiled
    assert fleet.trace_stats()["spec_steps"] > 0
    for node, bn, jn in zip(fleet.nodes, batched.nodes, jnodes):
        assert check.max_abs_diff(node.state, bn.state) == (0, [])
        ref = vms.to_reference(node.state)
        for f in jvms.VMState._fields:
            assert np.array_equal(getattr(ref, f), np.asarray(getattr(jn.state, f))), f


def test_push_plans_again():
    """push() verifies the states about to run: a node that loads a faulty
    program moves the fleet to the checked batched engine."""
    fleet = make_fleet([CLEAN, LOOPED], "auto")
    fleet.run(max_rounds=4)
    assert (fleet.executor_kind, fleet._elide) == ("cuda", True)
    node = fleet.nodes[0]
    node.launch(node.load(UNDERFLOW))
    fleet.push()
    assert (fleet.executor_kind, fleet._elide) == ("batched", False)
    fleet.run(max_rounds=4)
    assert int(node.state.tstatus[0]) == ST_ERR and int(node.state.last_exc[0]) == EXC_STACK


def test_auto_with_obs_counts_through_the_checked_engines(run_core_calls):
    """obs on an elided fleet counts through the checked counting instance,
    as the reference; the counters equal the checked batched fleet's."""
    from repro_torch.obs import ObsConfig

    out = {}
    for executor in ("auto", "batched"):
        fleet = make_fleet(AUTO_PROGS, executor, obs=ObsConfig(deadline_ms=1))
        fleet.run(max_rounds=8)
        out[executor] = (fleet.metrics().as_dict()["counters"],
                         vms.stack_states([vm.state for vm in fleet.nodes]))
    assert set(run_core_calls) == {(True, False)}
    assert out["auto"][0] == out["batched"][0]
    assert check.max_abs_diff(out["auto"][1], out["batched"][1]) == (0, [])


@pytest.mark.parametrize("case", ["spin_rnd", "ring_spawners"])
def test_predicted_bail_words_equal_observed_bail_hist(case):
    """Under executor="cuda" the statically predicted bail-out words are
    exactly the keys of the kernel's bail histogram."""
    if case == "spin_rnd":
        fleet, rounds, want = make_fleet([SPIN_RND] * 2, "cuda"), 4, ["rnd"]
    else:
        n = 16
        fleet = make_fleet([ann_program(i, n) for i in range(n)], "cuda", VMConfig())
        rounds, want = 200, ["rnd", "task"]
    predicted = fleet.analysis_stats()["predicted_bail_words"]
    res = fleet.run(max_rounds=rounds)
    assert predicted == want == sorted(fleet.kernel_stats()["bail_hist"])
    if case == "ring_spawners":
        assert res.statuses == ["halt"] * n
        auto = make_fleet([ann_program(i, n) for i in range(n)], "auto", VMConfig())
        auto.start()
        assert (auto.executor_kind, auto._elide) == ("batched", True)


# ---------------------------------------------------------------------------
# vmloop's checks-elided instance: the g++ build against the plain version
# and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_kernel():
    return _build_host()


def _elided_host_vs_plain(run, A, cfg, steps, rows=None, budget=None):
    B = vms.clone(A)
    _, *plain = pref.run_core(pref.core_of(A), pref.device_tables(None, "cpu"), steps, cfg,
                              rows=rows, budget=budget, elide_checks=True)
    kern = run(B, cfg, steps, rows=rows, budget=budget, elide=True)
    for name, a, b in zip(("n_exec", "bailed", "bail_op"), plain, kern):
        assert torch.equal(a, b), name
    assert check.max_abs_diff(A, B) == (0, [])
    return plain


@pytest.mark.parametrize("cfg", [CFG, VMConfig()], ids=["small", "default"])
def test_host_build_of_elided_instance_matches_plain_version(cfg, host_kernel):
    """The sweep and random states (which mostly do not verify, so stack
    pointers leave their stacks), the whole fleet and a shuffled row list
    with budgets: byte for byte, and on random states some rows do leave."""
    _elided_host_vs_plain(host_kernel, check.sweep_states(cfg, "cpu")[1], cfg, cfg.steps_per_slice)
    R = check.random_states(cfg, 256, cfg.cs_size + 11, "cpu")
    _elided_host_vs_plain(host_kernel, R, cfg, 64)
    assert bool(((R.dsp < 0) | (R.dsp > cfg.ds_size)).any())
    g = torch.Generator().manual_seed(cfg.cs_size)
    rows = torch.randperm(203, generator=g)[:150].to(torch.int32)
    budget = torch.randint(0, 70, (150,), generator=g).to(torch.int32)
    _elided_host_vs_plain(host_kernel, check.random_states(cfg, 203, 12, "cpu"), cfg, 64,
                          rows, budget)


def test_vmloop_call_refuses_obs_with_elided_checks():
    core = pref.core_of(check.random_states(CFG, 4, 0, "cpu"))
    with pytest.raises(ValueError, match="elide_checks"):
        kmod.vmloop_call(core, STEPS, CFG, obs=True, elide_checks=True)


@pytest.fixture(scope="module")
def jax_elided_vmloop():
    """The reference kernel's checks-elided loop, vmapped over nodes as
    ``ref.vmloop_ref`` does for the default one (one compile)."""
    run_core = jref.make_run_core(JCFG, elide_checks=True)
    tb = jref.Tables(*[jnp.asarray(x) for x in jref.make_tables()])

    def run(S):
        core, *out = jax.vmap(lambda c: run_core(c, tb, STEPS))(jref.core_of(S))
        return (jref.merge_core(S, core), *out)

    return jax.jit(run)


def _reference_out(fn, P):
    JS, *out = fn(jvms.VMState(*[jnp.array(x) for x in vms.to_reference(P)]))
    return JS, [np.asarray(x).astype(np.int32) for x in out]


def test_elided_instance_equals_reference_on_the_verified_sweep(jax_elided_vmloop, host_kernel):
    """The sweep programs that verify, through the reference's elided loop,
    the port's plain elided and checked versions and the g++ build of the
    elided instance: all equal.  Then random states of the same shape,
    which mostly do not verify (the reference leaves its result undefined
    there): the port's bytes equal the reference's all the same."""
    pairs = [(w, p) for w, p in check.sweep_programs(CFG)
             if w != "fios/trap" and getattr(outcome(analyze_source, p, CFG), "verdict", "") == VERIFIED]
    states = []
    for _, prog in pairs:
        vm = REXAVM(CFG, device="cpu")
        vm.launch(vm.load(prog))
        states.append(vm.state)
    S = vms.stack_states(states)
    interp_for(CFG).schedule(S)
    for A in (S, check.random_states(CFG, len(pairs), 13, "cpu")):
        checked = vms.clone(A)
        JS, jout = _reference_out(jax_elided_vmloop, A)
        plain = _elided_host_vs_plain(host_kernel, A, CFG, STEPS)
        ref = vms.to_reference(A)
        for f in jvms.VMState._fields:
            assert np.array_equal(np.asarray(getattr(JS, f)), getattr(ref, f)), f
        for name, a, b in zip(("n_exec", "bailed", "bail_op"), jout, plain):
            assert np.array_equal(a, b.numpy()), name
        if A is S:
            _, *cout = pref.vmloop_ref(checked, STEPS, CFG)
            assert check.max_abs_diff(A, checked) == (0, [])
            assert all(torch.equal(a, b) for a, b in zip(plain, cout))
            assert int(plain[0].sum()) > 0
        else:
            assert bool(((A.dsp < 0) | (A.dsp > CFG.ds_size)).any())


# ---------------------------------------------------------------------------
# Property: well-formed programs run alike with and without the checks
# ---------------------------------------------------------------------------

def _well_formed_program(lits, ops):
    """Push enough literals that the op suffix can never underflow."""
    return " ".join(str(v) for v in lits) + " " + " ".join(ops) + " halt"


def test_verified_programs_run_identically_with_checks_elided():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    checked, elided = interp_for(CFG), interp_for(CFG, elide_checks=True)
    j_elided = j_get_interpreter(JCFG, elide_checks=True)
    safe_ops = st.sampled_from(["+", "-", "*", "dup", "drop", "swap", "over", "1+"])

    @settings(max_examples=20, deadline=None)
    @given(lits=st.lists(st.integers(-100, 100), min_size=4, max_size=8),
           ops=st.lists(safe_ops, min_size=0, max_size=2))
    def prop(lits, ops):
        prog = _well_formed_program(lits, ops)
        assert analyze_source(prog, CFG).verdict == VERIFIED
        vm = REXAVM(CFG, backend="oracle", device="cpu")
        vm.launch(vm.load(prog))
        A, B = vms.stack1(vms.clone(vm.state)), vms.stack1(vms.clone(vm.state))
        checked.run_slice(A, 256)
        elided.run_slice(B, 256)
        assert check.max_abs_diff(A, B) == (0, [])
        j_state, _found = j_elided.run_slice(
            jvms.VMState(*[jnp.array(x) for x in vms.to_reference(vm.state)]), steps=256)
        ref = vms.to_reference(vms.unstack(B, 0))
        for f in jvms.VMState._fields:
            assert np.array_equal(np.asarray(getattr(j_state, f)), getattr(ref, f)), f
        assert int(B.tstatus[0, 0]) == ST_HALT

    prop()
