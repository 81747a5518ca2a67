"""The port's fleet, single node and router against the JAX package.

Workloads: the 64-node ring, the randomized messaging programs of
``tests/test_vm_fleet.py``, and the ``vecfold``/``dotprod`` ANN program of
``benchmarks/bench_vm.py`` (``bench_fleet_pallas_ann``).  Each runs under
``executor="batched"`` and ``executor="cuda"`` (on the CPU the latter takes
the kernel's plain version) and is held byte-exact against the reference's
``reference_round`` over ``REXAVM(backend="oracle")`` nodes, which costs no
XLA compile.
"""

import numpy as np
import pytest
import torch

from repro.config import VMConfig as JCfg
from repro.core.vm import REXAVM as JVM
from repro.core.vm import FleetVM as JFleet
from repro.core.vm import reference_round as jref_round

from repro_torch.config import VMConfig
from repro_torch.core.vm import REXAVM, FleetVM, HostLink, reference_round, vmstate as vms
from repro_torch.core.vm.spec import ST_HALT, get_isa
from repro_torch.launch.mesh import make_node_mesh

# The suite runs in several worker processes on shared cores: keep torch's
# CPU kernels to one thread each so these tests do not crowd out the rest.
torch.set_num_threads(1)

JCFG = JCfg(cs_size=2048, steps_per_slice=64, mbox_size=4)
CFG = VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4)
EXECUTORS = ["batched", "cuda"]


def ring_program(i: int, n: int) -> str:
    if i == 0:
        return f"1 {1 % n} send receive swap . . halt"
    return f"receive swap . 1+ {(i + 1) % n} send halt"


ANN = (
    "array x { 10 20 30 40 } "
    "array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
    "array y { 0 0 0 0 } "
    "0 begin 1+ x w y 0 vecfold x y dotprod drop dup 200 >= until "
    "drop halt"
)


def random_messaging(seed: int, n: int = 3, rounds_of: int = 4) -> list[list[str]]:
    """The generator of tests/test_vm_fleet.py (TestRandomizedPrograms)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds_of):
        progs = []
        for _i in range(n):
            units = []
            for _u in range(int(rng.integers(2, 7))):
                kind = int(rng.integers(0, 3))
                if kind == 0:
                    units.append(f"{int(rng.integers(0, 100))} {int(rng.integers(-1, n + 2))} send")
                elif kind == 1:
                    units.append("receive drop drop")
                else:
                    units.append(f"{int(rng.integers(0, 50))} .")
            progs.append(" ".join(units) + " halt")
        out.append(progs)
    return out


def make_fleet(progs, executor):
    fleet = FleetVM(CFG, n=len(progs), executor=executor, device="cpu")
    for node, prog in zip(fleet.nodes, progs):
        node.launch(node.load(prog))
    return fleet


def make_reference(progs):
    nodes = [JVM(JCFG, backend="oracle", seed=1 + i) for i in range(len(progs))]
    for node, prog in zip(nodes, progs):
        node.launch(node.load(prog))
    return nodes


def assert_equal(fleet, ref, skip=()):
    for i, (a, b) in enumerate(zip(fleet.nodes, ref)):
        pa = vms.to_reference(a.state)
        for f in vms.VMState._fields:
            if f in skip:
                continue
            assert np.array_equal(getattr(pa, f), np.asarray(getattr(b.state, f))), (i, f)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_64_node_ring(executor):
    n = 64
    progs = [ring_program(i, n) for i in range(n)]
    fleet = make_fleet(progs, executor)
    res = fleet.run(max_rounds=300)
    assert fleet.h2d == 1 and fleet.d2h == 1
    assert res.statuses == ["halt"] * n
    assert res.outputs[0] == f"{n - 1} {n} "
    ref = make_reference(progs)
    for _ in range(res.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal(fleet, ref, skip=("out", "outp"))       # run() drained the rings
    assert res.outputs == [vm.output() for vm in ref]
    stats = fleet.kernel_stats()
    if executor == "cuda":
        assert stats["kernel_steps"] > 0 and stats["bailed_node_rounds"] == 0
    else:
        assert stats["kernel_steps"] == 0


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("seed", [7, 11])
def test_random_messaging_lockstep(executor, seed):
    for progs in random_messaging(seed):
        fleet, ref = make_fleet(progs, executor), make_reference(progs)
        fleet.start()
        for _ in range(12):
            fleet.kernels.round(fleet._S, CFG.steps_per_slice)
        fleet.sync()
        for _ in range(12):
            jref_round(ref, JCFG.steps_per_slice)
        assert_equal(fleet, ref)


LOCKSTEP_CASES = {
    # the named fleets of tests/test_vm_fleet.py and test_vm_pallas.py
    "ring6": ([ring_program(i, 6) for i in range(6)], 16),
    "tasks_sleep_messages": ([
        ": worker 40 sleep 7 1 send ; 0 0 $ worker task drop receive . . receive . . halt",
        "receive 1+ swap send 5 sleep 99 0 send halt",
        "0 100 0 do 1+ loop . halt",
    ], 24),
    "invalid_destination": (["5 99 send 1 . halt", "0 200 0 do 1+ loop . halt"], 8),
    "backpressure": ([
        ": spray 0 10 0 do dup 1 send 1+ loop ; spray drop halt",
        "10 0 do receive . drop loop halt",
    ], 40),
    "flood_ring_wrap": ([
        " ".join(["receive drop drop"] * 8) + " halt",
        " ".join(f"{v} 0 send" for v in range(6)) + " halt",
        " ".join(f"{v + 100} 0 send" for v in range(6)) + " halt",
    ], 10),
}


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("case", sorted(LOCKSTEP_CASES))
def test_named_fleets_lockstep(case, executor):
    progs, rounds = LOCKSTEP_CASES[case]
    fleet, ref = make_fleet(progs, executor), make_reference(progs)
    fleet.start()
    for _ in range(rounds):
        fleet.kernels.round(fleet._S, CFG.steps_per_slice)
    fleet.sync()
    for _ in range(rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal(fleet, ref)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_ann_fleet(executor):
    n = 4
    fleet = make_fleet([ANN] * n, executor)
    res = fleet.run(max_rounds=120)
    assert res.statuses == ["halt"] * n
    ref = make_reference([ANN] * n)
    for _ in range(res.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal(fleet, ref)
    stats = fleet.kernel_stats()
    if executor == "cuda":
        assert stats["kernel_steps"] == stats["total_steps"] > 0
        assert stats["bail_hist"] == {}


def test_mixed_workload_service_every_8():
    """Tasks, sleeps, messaging, rnd and the ANN in one fleet, probed every
    8 rounds: both executors equal each other and the reference."""
    progs = [
        ": worker 40 sleep 7 1 send ; 0 0 $ worker task drop receive . . receive . . halt",
        "receive 1+ swap send 5 sleep 99 0 send halt",
        "0 100 0 do 1+ loop . 9 rnd . halt",
        ANN,
    ]
    results = {}
    for executor in EXECUTORS:
        fleet = make_fleet(progs, executor)
        res = fleet.run(max_rounds=200, service_every=8)
        assert res.statuses == ["halt"] * len(progs)
        results[executor] = (fleet, res)
    (fb, rb), (fc, rc) = results["batched"], results["cuda"]
    assert rb.rounds == rc.rounds and rb.outputs == rc.outputs
    for a, b in zip(fb.nodes, fc.nodes):
        assert vms.to_reference(a.state).cs.tobytes() == vms.to_reference(b.state).cs.tobytes()
        for f in vms.VMState._fields:
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    ref = make_reference(progs)
    for _ in range(rc.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal(fc, ref, skip=("out", "outp"))
    assert rc.outputs == [vm.output() for vm in ref]
    stats = fc.kernel_stats()
    assert stats["bail_hist"].get("task", 0) >= 1 and stats["bail_hist"].get("rnd", 0) >= 1
    assert 0 < stats["kernel_steps"] < stats["total_steps"]


# Programs that meet declined words (task, rnd, FIOS calls) several times a
# slice, each with the number of declined instructions one node executes.
HANDBACK_CASES = {
    "task_then_rnd": (": w 3 . end ; 0 0 $ w task drop 7 rnd . halt", 2),
    "rnd_loop": ("0 12 0 do 5 rnd + 1+ loop . halt", 12),
    "rnd_every_other": ("0 9 0 do 3 rnd drop 5 rnd drop 1+ loop . halt", 18),
    "fios_call": ("seven 1+ . seven . halt", 2),
    "exception_after_handback": (
        ": h 42 . ; $ h exception divbyzero catch 0= if 7 rnd 0 / drop endif 1 . halt", 1),
    "task_rnd_fios": (": w 9 rnd drop end ; 0 0 $ w task drop seven rnd 1 + . halt", 4),
}


def _handback_fleet(prog: str, n: int, executor: str):
    fleet = FleetVM(CFG, n=n, executor=executor, device="cpu")
    for node in fleet.nodes:
        node.fios_add("seven", lambda: 7, args=0, ret=1)
        node.launch(node.load(prog))
    return fleet


@pytest.mark.parametrize("case", sorted(HANDBACK_CASES))
def test_handback_equals_batched_and_reference(case):
    """executor="cuda" hands each declined word to the interpreter and
    resumes the kernel after it: byte-exact with executor="batched" and
    the reference, with only the declined instructions in the
    interpreter (fallback_steps)."""
    prog, declined = HANDBACK_CASES[case]
    n = 3
    out = {}
    for executor in EXECUTORS:
        fleet = _handback_fleet(prog, n, executor)
        res = fleet.run(max_rounds=60)
        assert res.statuses == ["halt"] * n, (executor, res.statuses)
        out[executor] = (fleet, res)
    (fb, rb), (fc, rc) = out["batched"], out["cuda"]
    assert rb.rounds == rc.rounds and rb.outputs == rc.outputs
    for a, b in zip(fb.nodes, fc.nodes):
        for f in vms.VMState._fields:
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    ref = [JVM(JCFG, backend="oracle", seed=1 + i) for i in range(n)]
    for node in ref:
        node.fios_add("seven", lambda: 7, args=0, ret=1)
        node.launch(node.load(prog))
    for _ in range(rc.rounds):
        jref_round(ref, JCFG.steps_per_slice)
        for node in ref:
            node._service_io()
    assert rc.outputs == [vm.output() for vm in ref]
    assert_equal(fc, ref, skip=("out", "outp"))           # run() drained the rings
    stats = fc.kernel_stats()
    assert stats["fallback_steps"] == declined * n
    assert (stats["kernel_steps"] + stats["fallback_steps"] == stats["total_steps"]
            == int(rc.steps.sum()))
    assert stats["bailed_node_rounds"] >= n


def test_handback_several_words_a_slice():
    """Within one slice a node hands back 18 declined words; the slice
    matches the batched executor, the kernel's counts sum over its
    launches, and each word counts once a node-round in the histogram."""
    prog, declined = HANDBACK_CASES["rnd_every_other"]
    steps = 256                                   # the whole program in one slice
    fleets = [_handback_fleet(prog, 2, e) for e in EXECUTORS]
    for fl in fleets:
        fl.start()
    fb, fc = fleets
    fb.kernels.round(fb._S, steps)
    layers = []
    S, n_exec, bailed, hist = fc.kernels.round_aux(fc._S, steps, mark=layers.append)
    for f in vms.VMState._fields:
        assert torch.equal(getattr(fb._S, f), getattr(S, f)), f
    assert S.tstatus[:, 0].tolist() == [ST_HALT, ST_HALT]
    rnd = get_isa().opcode["rnd"]
    assert bailed.tolist() == [1, 1] and int(hist[rnd]) == 2 and int(hist.sum()) == 2
    assert (S.steps - n_exec).tolist() == [declined, declined]
    assert layers == ["schedule", "kernel"] + ["tail", "kernel"] * declined + ["preempt"]


def test_ring_cell_bail_hist_counts_each_word():
    """The ring cell of chip_smoke.py at 32 nodes: every 16th node meets
    task and then rnd in round 0; each counts once under each word, and the
    interpreter runs only those two instructions a node."""
    n, iters = 32, 3

    def ann(i):
        extra = (": worker 5 0 do i acc +! loop ; 0 0 $ worker task drop 100 rnd acc +! "
                 if i % 16 == 0 else "")
        return ("array x { 10 20 30 40 } array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
                f"array y {{ 0 0 0 0 }} var acc {extra}"
                f"0 begin 1+ x w y 0 vecfold x y dotprod acc +! dup {iters} >= until drop "
                f"acc @ 4000 mod 2000 - sigmoid {(i + 1) % n} send "
                "receive swap drop acc ! acc @ . halt")

    results = {}
    for executor in EXECUTORS:
        fleet = make_fleet([ann(i) for i in range(n)], executor)
        results[executor] = (fleet, fleet.run(max_rounds=60))
    (fb, rb), (fc, rc) = results["batched"], results["cuda"]
    assert rc.statuses == ["halt"] * n and rc.outputs == rb.outputs
    for a, b in zip(fb.nodes, fc.nodes):
        for f in vms.VMState._fields:
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    stats = fc.kernel_stats()
    assert stats["bail_hist"] == {"task": 2, "rnd": 2}
    assert stats["fallback_steps"] == 4 and stats["bailed_node_rounds"] == 2


def test_kernel_stats_keys_equal_pallas_stats():
    jf = JFleet(JCFG, n=1)
    pf = FleetVM(CFG, n=1, executor="cuda", device="cpu")
    assert set(pf.kernel_stats()) == set(jf.pallas_stats())


def test_host_io_fios_and_out_serviced():
    n = 3
    fleet = FleetVM(CFG, n=n, device="cpu", executor="cuda")
    for i, node in enumerate(fleet.nodes):
        node.dios_add("samples", np.zeros(8, np.int32))
        node.dios_add("ready", np.array([0], np.int32))

        def adc(scale, node=node, i=i):
            node.dios_write("samples", np.arange(8, dtype=np.int32) * scale * (i + 1))
            node.dios_write("ready", [1])

        node.fios_add("adc", adc, args=1, ret=0)
        node.launch(node.load("2 adc 1000 1 ready await drop samples vecmax out halt"))
    res = fleet.run(max_rounds=100)
    assert res.statuses == ["halt"] * n
    assert [vm.out_stream for vm in fleet.nodes] == [[7]] * n
    assert fleet.h2d == 1 and fleet.d2h == 1 and fleet.io_service.services >= 1
    assert fleet.kernel_stats()["bail_hist"].get("fios/trap", 0) >= 1


def test_reference_round_port_equals_reference():
    """The port's own host-routed reference_round equals the reference's."""
    progs = random_messaging(3)[0] + ["0 50 0 do 1+ loop . halt"]
    nodes = [REXAVM(CFG, seed=1 + i, device="cpu") for i in range(len(progs))]
    for node, prog in zip(nodes, progs):
        node.launch(node.load(prog))
    ref = make_reference(progs)
    for _ in range(10):
        assert reference_round(nodes, 64) == jref_round(ref, 64)
    for a, b in zip(nodes, ref):
        pa = vms.to_reference(a.state)
        for f in vms.VMState._fields:
            assert np.array_equal(getattr(pa, f), np.asarray(getattr(b.state, f))), f


QUICKSTART = [
    ': fib dup 2 < if drop 1 else dup 1 - fib swap 2 - fib + endif ; 10 fib . cr',
    '." sigmoid(1.0)=" 1000 sigmoid . cr ." sin(pi/2)=" 1571 sin . cr',
    "array x { 500 -200 300 } array w { 10 -5 3 2 0 1 } array b { -4 5 } array s { -4 -4 } "
    "array h 2 x w h s vecfold h b h 0 vecadd h h 0 0 vecmap "
    '." activations: " h vecprint cr ." class: " h vecmax . cr',
]


def test_single_node_quickstart_programs():
    cfg, jcfg = VMConfig(cs_size=8192, steps_per_slice=2048), JCfg(cs_size=8192, steps_per_slice=2048)
    pv, jv = REXAVM(cfg, device="cpu"), JVM(jcfg, backend="oracle")
    for prog in QUICKSTART:
        a, b = pv.eval(prog), jv.eval(prog)
        assert (a.output, a.status, a.steps, a.slices) == (b.output, b.status, b.steps, b.slices)
    pv.run(pv.load(": classify 100 * ; export classify"))
    jv.run(jv.load(": classify 100 * ; export classify"))
    assert pv.eval("3 classify .").output == jv.eval("3 classify .").output == "300 "
    pa = vms.to_reference(pv.state)
    for f in vms.VMState._fields:
        assert np.array_equal(getattr(pa, f), np.asarray(getattr(jv.state, f))), f
    assert pv.executor.h2d == pv.executor.d2h > 0


def test_single_node_multitask_and_streams():
    prog = "var flag : w 1 flag ! end ; 0 0 $ w task drop 100 1 flag await . flag @ . in out halt"
    pv, jv = REXAVM(CFG, device="cpu"), JVM(JCFG, backend="oracle")
    pv.in_queue.append(41)
    jv.in_queue.append(41)
    a, b = pv.run(pv.load(prog)), jv.run(jv.load(prog))
    assert (a.output, a.status, a.steps) == (b.output, b.status, b.steps)
    assert pv.out_stream == jv.out_stream == [41]


def test_hostlink():
    a, b = REXAVM(CFG, seed=1, device="cpu"), REXAVM(CFG, seed=2, device="cpu")
    link = HostLink([a, b])
    a.launch(a.load("7 1 send 42 9 send halt"))
    b.launch(b.load("receive . . halt"))
    for _ in range(10):
        a._slice(64)
        a._service_io()
        b._slice(64)
        b._service_io()
        if int(b.state.tstatus[0]) == ST_HALT:
            break
    assert b.output() == "7 0 "
    assert link.dropped == [(0, 9, 42)]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        REXAVM(CFG)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FleetVM(CFG, n=2)
    with pytest.raises(ValueError, match="executor"):
        FleetVM(CFG, n=2, executor="pallas", device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_node_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_node_mesh(4, device="cuda")
