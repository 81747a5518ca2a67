"""The port's Oracle, its oracle executors, the ensemble, checkpointing and
numbered syscalls against the JAX package.

Inputs: the per-opcode sweep of ``tests/test_torch_vmloop.py`` (every word,
FIOS, the edge values: int32 extremes, divisor 0, INT_MIN operands of ``/``
and ``mod``), the ring and named fleets of ``tests/test_torch_fleet.py``,
and a counting loop for the ensemble.  The references are the JAX
package's plain-Python Oracle and ``reference_round``, which cost no XLA
compile.  Every comparison is exact on every field; each framework gets its
own copy of every array.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core.vm import REXAVM as JVM
from repro.core.vm import reference_round as jref_round
from repro.core.vm import vmstate as jvms
from repro.core.vm.ensemble import EnsembleVM as JEnsemble
from repro.core.vm.oracle import Oracle as JOracle
from repro.resilience.voting import ReplicaVoter as JVoter
from test_torch_fleet import LOCKSTEP_CASES, assert_equal, make_fleet, make_reference, ring_program
from test_torch_vmloop import CFG, JCFG, PAIRS, STEPS, ref_states  # noqa: F401  (a fixture)

from repro_torch.core.vm import (
    REXAVM,
    EnsembleVM,
    FleetVM,
    Oracle,
    make_executor,
    reference_round,
    replicate_state,
    vmstate as vms,
)
from repro_torch.core.vm.spec import FIOS_BASE, ST_HALT
from repro_torch.resilience import ReplicaVoter

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
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)


# ---------------------------------------------------------------------------
# The Oracle, field for field against the reference Oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(len(PAIRS)), ids=[f"{i:03d}-{w}" for i, (w, _) in enumerate(PAIRS)])
def test_oracle_equals_reference_oracle(k, ref_states):
    """Three ``run_slice`` calls of one sweep program through both Oracles
    (``found`` and every field after each), and three ``step`` calls
    after, which run whatever the state holds (an ended task included)."""
    jst = _node(ref_states, k)
    pst = vms.from_reference(_node(ref_states, k), "cpu")
    jo, po = JOracle(JCFG), Oracle(CFG)
    for s in range(3):
        jst, jfound = jo.run_slice(jst, STEPS)
        pst2, pfound = po.run_slice(pst, STEPS)
        assert pst2 is pst and bool(jfound) == bool(pfound), (PAIRS[k], s)
        _assert_fields(pst, jst, (PAIRS[k], s))
    for s in range(3):
        jo.step(jst)
        po.step(pst)
    _assert_fields(pst, jst, (PAIRS[k], "step"))


def test_oracle_keeps_the_reference_oracles_int_min_division():
    """INT_MIN / 3 and INT_MIN mod 3: the reference Oracle's ``_truncdiv``
    gives -715827882 and -2; the interpreter and the kernel give 715827883
    and -2147483648 - 3 * 715827883 (``abs`` wraps at INT_MIN; see
    tests/test_torch_interp.py).  The port's Oracle is held to the
    reference Oracle."""
    for prog, oracle_v in (("-2147483648 3 / halt", -715827882), ("-2147483648 3 mod halt", -2)):
        jv, pv = JVM(JCFG, backend="oracle"), REXAVM(CFG, backend="oracle", device="cpu")
        jv.run(jv.load(prog))
        pv.run(pv.load(prog))
        assert int(jv.state.ds[0, 0]) == int(pv.state.ds[0, 0]) == oracle_v, prog
        tv = REXAVM(CFG, device="cpu")
        tv.run(tv.load(prog))
        assert int(tv.state.ds[0, 0]) != oracle_v, prog


def test_oracle_accepts_numpy_states(ref_states):
    """The Oracle runs on a numpy state as on CPU tensors."""
    k = [w for w, _ in PAIRS].index("vecfold")
    a = vms.from_reference(_node(ref_states, k), "cpu")
    b = vms.to_reference(vms.clone(a))
    po = Oracle(CFG)
    po.run_slice(a, STEPS)
    po.run_slice(b, STEPS)
    _assert_fields(a, b, "numpy")


# ---------------------------------------------------------------------------
# REXAVM(backend="oracle") and FleetVM(executor="oracle")
# ---------------------------------------------------------------------------

QUICKSTART = [
    "1 2 + . cr",
    ": sq dup * ; 7 sq .",
    "array a { 1 2 3 4 } a 2 get .",
    "0 10 0 do i + loop .",
    "100 sigmoid . 1000 sin . 10000 sqrt .",
]


@pytest.mark.parametrize("prog", QUICKSTART)
def test_single_node_oracle_backend_equals_reference(prog):
    jv = JVM(JCFG, backend="oracle")
    pv = REXAVM(CFG, backend="oracle", device="cpu")
    assert pv.oracle is not None and pv.executor.backend == "oracle"
    jr, pr = jv.eval(prog), pv.eval(prog)
    assert (jr.status, jr.steps, jr.output, jr.slices) == (pr.status, pr.steps, pr.output, pr.slices)
    _assert_fields(pv.state, jv.state, prog)


@pytest.mark.parametrize("n", [8, 32])
def test_oracle_fleet_ring_equals_batched_and_reference(n):
    progs = [ring_program(i, n) for i in range(n)]
    fo, fb = make_fleet(progs, "oracle"), make_fleet(progs, "batched")
    ro, rb = fo.run(max_rounds=200), fb.run(max_rounds=200)
    assert ro.statuses == ["halt"] * n and ro.rounds == rb.rounds and ro.outputs == rb.outputs
    for a, b in zip(fo.nodes, fb.nodes):
        assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))
    ref = make_reference(progs)
    for _ in range(ro.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal(fo, ref, skip=("out", "outp"))
    assert fo.kernel_stats()["kernel_steps"] == 0


@pytest.mark.parametrize("case", list(LOCKSTEP_CASES))
def test_oracle_fleet_lockstep_named(case):
    """Round by round: the oracle fleet's round against the reference's
    ``reference_round`` and the port's own."""
    progs, rounds = LOCKSTEP_CASES[case]
    fleet, ref = make_fleet(progs, "oracle"), make_reference(progs)
    mine = [REXAVM(CFG, backend="oracle", seed=1 + i, device="cpu") for i in range(len(progs))]
    for node, prog in zip(mine, progs):
        node.launch(node.load(prog))
    fleet.start()
    for _ in range(rounds):
        fleet.kernels.round(fleet._S, CFG.steps_per_slice)
        jref_round(ref, JCFG.steps_per_slice)
        reference_round(mine, CFG.steps_per_slice)
    fleet.sync()
    assert_equal(fleet, ref)
    for a, b in zip(mine, ref):
        _assert_fields(a.state, b.state, case)


def test_oracle_fleet_services_host_io():
    fleet = FleetVM(CFG, n=2, executor="oracle", device="cpu")
    for node in fleet.nodes:
        node.fios_add("seven", lambda: 7, args=0, ret=1)
        node.launch(node.load("seven . 5 out halt"))
    res = fleet.run(max_rounds=20)
    assert res.statuses == ["halt", "halt"] and res.outputs == ["7 ", "7 "]
    assert [vm.out_stream for vm in fleet.nodes] == [[5], [5]]


# ---------------------------------------------------------------------------
# The ensemble and voting
# ---------------------------------------------------------------------------

COUNTER = "0 200 0 do i + loop . halt"


def _flip(S, k, field, where, bit):
    x = getattr(S, field)
    x[(k,) + where] = x[(k,) + where] ^ (1 << bit)


@pytest.mark.parametrize("executor", ["batched", "cuda"])
@pytest.mark.parametrize("field,where,bit", [("ds", (0, 0), 5), ("mem", (3,), 30), ("pc", (0,), 1)])
def test_ensemble_votes_equal_reference(executor, field, where, bit):
    """Five replicas of one node, replica 3 bit-flipped after the first
    slice (mid-loop: the running sum on the stack, memory, the pc): each
    later slice's states equal the reference Oracle's on every replica, and
    the port's vote, fault flags and heal equal the reference
    ``EnsembleVM``'s on the same states."""
    n = 5
    jv, pv = JVM(JCFG, backend="oracle"), REXAVM(CFG, device="cpu")
    jv.launch(jv.load(COUNTER))
    pv.launch(pv.load(COUNTER))
    ens = EnsembleVM(CFG, n=n, executor=executor, device="cpu")
    jens = JEnsemble(JCFG, n=n)
    S = ens.run_slice(ens.replicate(pv.state))
    _flip(S, 3, field, where, bit)
    ref = [_node(vms.to_reference(S), i) for i in range(n)]
    jo = JOracle(JCFG)
    for s in range(3):
        S = ens.run_slice(S)
        ref = [jo.run_slice(st, JCFG.steps_per_slice)[0] for st in ref]
        JS = jvms.stack_states(ref)
        _assert_fields(S, JS, (executor, field, s))
        pvote, jvote = ens.vote(S), jens.vote(JS)
        assert np.array_equal(pvote.votes, jvote.votes) and pvote.faulty == jvote.faulty
        assert pvote.agree == jvote.agree
        assert np.array_equal(ens.checksum(S), jens.checksum(JS))
    assert pvote.faulty == [3] and not pvote.agree
    healed, jhealed = ens.heal(S, pvote), jens.heal(JS, jvote)
    _assert_fields(healed, jvms.VMState(*[np.asarray(x) for x in jhealed]), "heal")
    assert ens.vote(healed).agree


def test_replicate_state_equals_reference():
    from repro.core.vm.ensemble import replicate_state as jreplicate

    jv, pv = JVM(JCFG, backend="oracle"), REXAVM(CFG, device="cpu")
    jv.launch(jv.load(COUNTER))
    pv.launch(pv.load(COUNTER))
    J = jreplicate(jv.state, 3)
    P = replicate_state(pv.state, 3)
    P.ds[0, 0, 0] = 99                     # the replicas are copies, not views
    assert int(P.ds[1, 0, 0]) == 0
    P.ds[0, 0, 0] = 0
    _assert_fields(P, jvms.VMState(*[np.asarray(x) for x in J]), "replicate")


def test_replica_voter_equals_reference():
    digests = [(1.0, 2.0, 3.0), (1.0, 2.0, 3.0), (1.0, 2.5, 3.0), (1.0, 2.0, 3.0)]
    pv, jv = ReplicaVoter(4), JVoter(4)
    for step in range(3):
        d = [pv.digest(*x) for x in digests]
        assert d == [jv.digest(*x) for x in digests]
        a, b = pv.vote(step, d), jv.vote(step, d)
        assert (a.agree, a.faulty) == (b.agree, b.faulty) == ((False, [2]) if step == 0 else (True, []))
        digests[2] = digests[0]
    assert pv.fault_rate == jv.fault_rate


def test_ensemble_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        EnsembleVM(CFG, n=3)
    with pytest.raises(ValueError, match="executor"):
        EnsembleVM(CFG, n=3, executor="oracle", device="cpu")


# ---------------------------------------------------------------------------
# checkpoint / restore and numbered syscalls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_checkpoint_restore_round_trip_equals_reference(backend):
    """Checkpoints taken mid-run compare field for field (dtypes included)
    with the reference's; a port node restored from the reference's
    checkpoint (and the reference from the port's) runs on identically."""
    prog = ": w 20 0 do i . loop ; 0 0 $ w task drop 0 300 0 do i + loop . 7 rnd . halt"
    jv, pv = JVM(JCFG, backend="oracle"), REXAVM(CFG, backend=backend, device="cpu")
    jv.launch(jv.load(prog))
    pv.launch(pv.load(prog))
    for _ in range(3):
        jv._slice(JCFG.steps_per_slice)
        pv._slice(CFG.steps_per_slice)
    jc, pc = jv.checkpoint(), pv.checkpoint()
    assert jc["now"] == pc["now"]
    for f in jvms.VMState._fields:
        a, b = np.asarray(getattr(jc["state"], f)), getattr(pc["state"], f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    pv2 = REXAVM(CFG, backend=backend, device="cpu")
    pv2.restore(jc)
    jv2 = JVM(JCFG, backend="oracle")
    jv2.restore({"state": jvms.VMState(*[np.array(x) for x in pc["state"]]), "now": pc["now"]})
    for vm in (jv, pv, pv2, jv2):
        vm.run(max_slices=50)
    for p, j in ((pv, jv), (pv2, jv), (pv, jv2)):
        _assert_fields(p.state, j.state, backend)
    pv.restore(pc)                        # the snapshot is a copy
    assert int(pv.state.steps) == int(pc["state"].steps) < int(pv2.state.steps)


def test_svc_add_numbering_equals_reference():
    """Pinned numbers, the lowest free number around them, re-registration
    and the refusals, as the reference's syscall table; frames compile to
    the same bytecode and run the same callbacks."""
    jv, pv = JVM(JCFG, backend="oracle"), REXAVM(CFG, device="cpu")
    plan = [("pinned", 5), ("a", None), ("b", None), ("c", 2), ("d", None), ("pinned", None)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name, num in plan:
            fn = (lambda k: (lambda: k))(len(name))
            assert jv.svc_add(name, fn, ret=1, num=num) == pv.svc_add(name, fn, ret=1, num=num)
        assert jv.fios_add("e", lambda: 1, ret=1) == pv.fios_add("e", lambda: 1, ret=1)
    assert pv.fios.by_name == jv.fios.table.numbers()
    assert pv.fios.opcode("pinned") == FIOS_BASE + 5
    for bad in ((("a",), {"num": 7}), (("z",), {"num": 2}), (("z",), {"num": 62})):
        (name,), kw = bad
        with pytest.raises(ValueError):
            jv.svc_add(name, lambda: 0, **kw)
        with pytest.raises(ValueError):
            pv.svc_add(name, lambda: 0, **kw)
    prog = "pinned . a . c . d . e . halt"
    jf, pf = jv.load(prog), pv.load(prog)
    assert np.array_equal(np.asarray(jv.state.cs)[jf.start:jf.end], pv.state.cs.numpy()[pf.start:pf.end])
    jr, pr = jv.run(jf), pv.run(pf)
    assert jr.output == pr.output == "6 1 1 1 1 " and pr.status == "halt"
    assert int(pv.state.tstatus[0]) == ST_HALT


def test_make_executor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    for backend in ("torch", "oracle"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make_executor(backend, CFG)
        assert make_executor(backend, CFG, device="cpu").backend == backend
    with pytest.raises(RuntimeError, match='device="cpu"'):
        REXAVM(CFG, backend="oracle")
    with pytest.raises(ValueError, match="backend"):
        make_executor("jit", CFG, device="cpu")
