"""The port's Executive (``repro_torch.exec``) against the JAX package's.

Mirrors ``tests/test_vm_exec.py``:

* the reference's five task-word scenarios (``TASK_SWEEP``) under the
  port's ``batched``, ``cuda`` (the kernel's plain version on the CPU) and
  ``oracle`` fleets with ``ExecutiveConfig(quantum=16, slices=4)``, every
  ``VMState`` field and out stream byte-exact against the JAX package's
  ``reference_round(executive=)`` replayed for the same rounds (and so is
  the port's own ``reference_round(executive=)``), with the same
  ``task_switches``/``preemptions``; one of them also against the JAX
  ``FleetVM(executor="batched", executive=)``'s counters and states;
* the scheduler's guarantees (strict priority starves, equal priorities
  round-robin) and a hypothesis property over random spawn/sleep/yield/
  priority interleavings against the JAX reference round;
* the syscall plane: ``io_mode="vector"`` byte-exact against
  ``"partial"``, one batch per shared vectorized handler, the post ring's
  drop rule, the UART/FS/CAN trio at the reference's pinned numbers, the
  ``SyscallTable`` numbering and the ``FiosRegistry`` shim, each as the
  reference's;
* admission (no-slot, infeasible, no-energy, the WCET default) with the
  port's ``Admission`` log equal to the reference's for the same calls,
  task deadline misses, the executive/obs exclusion, ``ExecutiveConfig``
  validation and the key set of ``metrics()["executive"]``.

The JAX side runs ``reference_round`` over ``REXAVM(backend="oracle")``
nodes, which compiles nothing; the JAX fleet's Executive round compiles
once (~30 s of the file's ~55 s).  Each framework gets its own
copy of every array.
"""

import json
import types
import warnings

import numpy as np
import pytest
import torch

from repro.config import VMConfig as JCfg
from repro.core.vm import REXAVM as JVM
from repro.core.vm import FleetVM as JFleet
from repro.core.vm import reference_round as jref_round
from repro.exec import Executive as JExecutive
from repro.exec import ExecutiveConfig as JExecCfg
from repro.exec import SyscallTable as JSyscallTable
from repro.exec import services as jservices
from repro.resilience.checkpoint import CheckpointManager as JCheckpointManager
from repro.sched.lsa import EnergyModel as JEnergy

from repro_torch.config import VMConfig
from repro_torch.core.vm import REXAVM, FleetVM, reference_round, vmstate as vms
from repro_torch.core.vm.spec import FIOS_BASE, MAX_FIOS, MEM_BASE
from repro_torch.exec import (
    Executive,
    ExecutiveConfig,
    SyscallTable,
    install_services,
    services,
)
from repro_torch.resilience import CheckpointManager
from repro_torch.sched import EnergyModel

torch.set_num_threads(1)

JCFG = JCfg(cs_size=2048, steps_per_slice=64, mbox_size=4)
CFG = VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4)
JECFG = JExecCfg(quantum=16, slices=4)
ECFG = ExecutiveConfig(quantum=16, slices=4)
EXECUTORS = ("batched", "cuda", "oracle", "trace")


# ---------------------------------------------------------------------------
# Both sides of one scenario
# ---------------------------------------------------------------------------

def _program(nodes, executive, mains, spawns):
    for node, prog in zip(nodes, mains):
        if prog:
            node.launch(node.load(prog))
    for node_i, prog, prio, deadline in spawns:
        executive.spawn(node_i, prog, prio=prio, deadline=deadline)


def _build(executor, mains, spawns=(), io_mode=None, ecfg=ECFG):
    """A port fleet with per-node main programs and Executive-spawned tasks
    (``spawns``: (node, program, prio, deadline) in order)."""
    fleet = FleetVM(CFG, n=len(mains), executor=executor, executive=ecfg, io_mode=io_mode,
                    device="cpu")
    ex = Executive(fleet)
    _program(fleet.nodes, ex, mains, spawns)
    return fleet, ex


def _jax_nodes(n):
    nodes = [JVM(JCFG, backend="oracle", seed=1 + i) for i in range(n)]
    return nodes, JExecutive(types.SimpleNamespace(nodes=nodes))


def _reference(mains, rounds, spawns=()):
    """The JAX package's Executive round replayed ``rounds`` times on
    fresh Oracle nodes, each round followed by the per-node host service."""
    nodes, ex = _jax_nodes(len(mains))
    _program(nodes, ex, mains, spawns)
    obs: dict = {}
    for _ in range(rounds):
        jref_round(nodes, obs=obs, executive=JECFG)
        for vm in nodes:
            vm._service_io(route_net=False)
    return nodes, obs


def _port_reference(mains, rounds, spawns=()):
    """The port's ``reference_round(executive=)`` replayed the same way (its
    nodes only hold the states; the round slices through the Oracle)."""
    fleet, _ = _build("oracle", mains, spawns)
    obs: dict = {}
    for _ in range(rounds):
        reference_round(fleet.nodes, obs=obs, executive=ECFG)
        for vm in fleet.nodes:
            vm._service_io(route_net=False)
    return fleet.nodes, obs


def _assert_states_equal(port_nodes, ref_nodes, ctx=""):
    for i, (p, j) in enumerate(zip(port_nodes, ref_nodes)):
        mine = vms.to_reference(p.state)
        for f in mine._fields:
            a, b = getattr(mine, f), np.asarray(getattr(j.state, f))
            assert np.array_equal(a, b.astype(a.dtype)), (ctx, i, f)
        assert p.out_stream == j.out_stream, (ctx, i)


def _assert_port_equal(a_nodes, b_nodes, ctx=""):
    for i, (a, b) in enumerate(zip(a_nodes, b_nodes)):
        for f, x, y in zip(a.state._fields, a.state, b.state):
            assert torch.equal(x, y), (ctx, i, f)
        assert a.out_stream == b.out_stream, (ctx, i)


# ---------------------------------------------------------------------------
# The task-word scenarios (the reference's TASK_SWEEP, verbatim)
# ---------------------------------------------------------------------------

TASK_SWEEP = [
    ("spawn-word", [": w 3 0 do 7 out loop ;\n1 0 $ w task out 5 out",
                    "2 out"], ()),
    ("host-spawn", ["5 0 do i out loop", "1 2 + out"],
     ((0, ": bg 2 0 do 100 out loop ;\nbg", 1, 0),
      (1, "200 out", 3, 0))),
    ("sleep-mix", [": w 2 sleep 9 out ;\n0 0 $ w task drop yield 4 out",
                   "1 sleep taskid out ms out"], ()),
    ("await-timeout", [f"2 1 {MEM_BASE + 40} await out", "yield 8 out"],
     ((0, "3 sleep 77 out", 2, 0),)),
    ("preempt-heavy", ["0 begin 1+ dup 200 >= until out"],
     ((0, "0 begin 1+ dup 150 >= until out", 1, 0),)),
]
NAMES = [n for n, _, _ in TASK_SWEEP]
JAX_FLEET_SCENARIOS = ("spawn-word",)


@pytest.fixture(scope="module")
def sweep_runs():
    """Every scenario under every port executor, and the JAX reference
    replayed for the batched fleet's rounds."""
    out = {}
    for name, mains, spawns in TASK_SWEEP:
        runs = {}
        for executor in EXECUTORS:
            fleet, _ = _build(executor, mains, spawns)
            runs[executor] = (fleet, fleet.run(max_rounds=60))
        rounds = runs["batched"][1].rounds
        runs["reference"] = _reference(mains, rounds, spawns)
        runs["port_reference"] = _port_reference(mains, rounds, spawns)
        out[name] = runs
    return out


@pytest.mark.parametrize("name", NAMES)
def test_port_reference_round_equals_reference(name, sweep_runs):
    """The port's own ``reference_round(executive=)`` lands on the JAX
    package's bytes and counts."""
    nodes, obs = sweep_runs[name]["port_reference"]
    ref_nodes, ref_obs = sweep_runs[name]["reference"]
    _assert_states_equal(nodes, ref_nodes, name)
    assert obs == ref_obs


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("name", NAMES)
def test_task_words_byte_exact_against_reference(name, executor, sweep_runs):
    runs = sweep_runs[name]
    fleet, res = runs[executor]
    assert res.rounds == runs["batched"][1].rounds, (name, executor)
    _assert_states_equal(fleet.nodes, runs["reference"][0], (name, executor))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("name", NAMES)
def test_task_counters_match_reference(name, executor, sweep_runs):
    _, obs = sweep_runs[name]["reference"]
    fleet, _ = sweep_runs[name][executor]
    e = fleet.executive_stats()
    assert e["enabled"] and e["quantum"] == ECFG.quantum and e["slices_per_round"] == ECFG.slices
    assert e["task_switches"] == obs.get("task_switches", 0), (name, executor, e, obs)
    assert e["preemptions"] == obs.get("preemptions", 0), (name, executor, e, obs)
    assert e["exec_slices"] == ECFG.slices * fleet.rounds_total > 0
    ks = fleet.kernel_stats()
    assert ks["exec_slices"] == (e["exec_slices"] if executor == "cuda" else 0)
    if executor == "cuda":
        # Every instruction ran in the kernel or was handed back.
        assert ks["kernel_steps"] + ks["fallback_steps"] == ks["total_steps"] > 0


def test_preemptions_counted(sweep_runs):
    _, obs = sweep_runs["preempt-heavy"]["reference"]
    assert obs.get("preemptions", 0) > 0 and obs.get("task_switches", 0) > 0


def test_task_word_hands_back_to_the_interpreter(sweep_runs):
    """The ``task`` word is declined by the kernel inside a quantum."""
    fleet, _ = sweep_runs["spawn-word"]["cuda"]
    assert fleet.kernel_stats()["bail_hist"].get("task", 0) > 0


@pytest.mark.parametrize("name", JAX_FLEET_SCENARIOS)
def test_counters_match_jax_fleet(name, sweep_runs):
    """The JAX package's batched Executive fleet reports the port's counts,
    rounds and states."""
    mains, spawns = next((m, s) for n, m, s in TASK_SWEEP if n == name)
    jf = JFleet(JCFG, n=len(mains), executor="batched", executive=JECFG)
    _program(jf.nodes, JExecutive(jf), mains, spawns)
    jres = jf.run(max_rounds=60)
    fleet, res = sweep_runs[name]["batched"]
    assert jres.rounds == res.rounds
    je, pe = jf.executive_stats(), fleet.executive_stats()
    for key in ("task_switches", "preemptions", "exec_slices", "spawns_admitted",
                "spawns_rejected", "task_deadline_misses", "tasks_missed", "syscalls",
                "svc_batches", "svc_scalar_calls"):
        assert je[key] == pe[key], (name, key)
    _assert_states_equal(fleet.nodes, jf.nodes, name)


# ---------------------------------------------------------------------------
# The scheduler's guarantees
# ---------------------------------------------------------------------------

_BUMP = ": bump begin {addr} @ 1+ {addr} ! again ;\nbump"


def _progress_cells(executor, prio_a, prio_b):
    """Two endless increment loops in slots 1 and 2: their counters after
    one Executive round."""
    addr_a, addr_b = MEM_BASE + 8, MEM_BASE + 9
    fleet, _ = _build(executor, [""], ((0, _BUMP.format(addr=addr_a), prio_a, 0),
                                       (0, _BUMP.format(addr=addr_b), prio_b, 0)))
    fleet.run(max_rounds=1)
    mem = fleet.nodes[0].state.mem.numpy()
    return int(mem[addr_a - MEM_BASE]), int(mem[addr_b - MEM_BASE])


@pytest.mark.parametrize("executor", EXECUTORS)
def test_priority_starves_lower(executor):
    a, b = _progress_cells(executor, 0, 5)
    assert b > 0 and a == 0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_equal_priority_round_robins(executor):
    a, b = _progress_cells(executor, 2, 2)
    assert a > 0 and b > 0


def test_prio_is_a_full_int32():
    """Priorities at the ends of int32 order as integers (no folded score
    that could overflow), on the interpreter and the Oracle alike."""
    lo, hi = -(2 ** 31), 2 ** 31 - 1
    for executor in ("batched", "oracle"):
        a, b = _progress_cells(executor, lo, hi)
        assert b > 0 and a == 0, executor
        a, b = _progress_cells(executor, hi, hi - 1)
        assert a > 0 and b == 0, executor


# ---------------------------------------------------------------------------
# Random interleavings against the JAX reference round
# ---------------------------------------------------------------------------

_MAIN_TOKENS = ("1 out", "2 sleep", "yield", "3 0 do i drop loop", "9 out")
_BG_TOKENS = ("100 out", "1 sleep", "yield", "0 begin 1+ dup 40 >= until drop")


def _check_interleaving(mains, spawns):
    rows = tuple((n, prog, prio, 0) for n, prog, prio in spawns)
    fleet, _ = _build("batched", mains, rows)
    res = fleet.run(max_rounds=24)
    ref_nodes, _ = _reference(mains, res.rounds, rows)
    _assert_states_equal(fleet.nodes, ref_nodes, "interleaving")


def test_random_interleavings_match_reference():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st_h

    mains_st = st_h.lists(
        st_h.lists(st_h.sampled_from(_MAIN_TOKENS), min_size=1, max_size=4).map(" ".join),
        min_size=2, max_size=2,
    )
    spawns_st = st_h.lists(
        st_h.tuples(
            st_h.integers(0, 1),
            st_h.lists(st_h.sampled_from(_BG_TOKENS), min_size=1, max_size=3).map(" ".join),
            st_h.integers(0, 3),
        ),
        min_size=0, max_size=3,
    )

    @settings(max_examples=8, deadline=None, database=None)
    @given(mains=mains_st, spawns=spawns_st)
    def prop(mains, spawns):
        _check_interleaving(mains, spawns)

    prop()


@pytest.mark.parametrize("case", [
    (["2 sleep 1 out", "yield 9 out"], []),
    (["1 out yield 9 out", "3 0 do i drop loop 1 out"],
     [(0, "100 out 1 sleep 100 out", 3), (1, "yield 100 out", 0)]),
    (["9 out 2 sleep 9 out", "1 out"],
     [(1, "0 begin 1+ dup 40 >= until drop", 2), (1, "1 sleep 100 out", 2), (0, "yield", 1)]),
])
def test_fixed_interleavings_match_reference(case):
    _check_interleaving(*case)


# ---------------------------------------------------------------------------
# The vectorized syscall plane
# ---------------------------------------------------------------------------

def _svc_fleet(io_mode, vectorized, n=6, executor="batched"):
    fleet = FleetVM(CFG, n=n, executor=executor, io_mode=io_mode, device="cpu")
    if vectorized:
        def double(rows, svc):
            return [2 * r.args[0] for r in rows]
    else:
        def double(v):
            return 2 * v
    for i, node in enumerate(fleet.nodes):
        node.svc_add("double", double, args=1, ret=1, vectorized=vectorized)
        node.launch(node.load(f"{i + 1} double out  {10 * (i + 1)} double out"))
    return fleet


@pytest.mark.parametrize("executor", ["batched", "cuda"])
def test_vector_mode_byte_exact_vs_partial(executor):
    a = _svc_fleet("partial", vectorized=False, executor=executor)
    b = _svc_fleet("vector", vectorized=False, executor=executor)
    c = _svc_fleet("full", vectorized=False, executor=executor)
    ra, rb, rc = (f.run(max_rounds=30) for f in (a, b, c))
    assert ra.rounds == rb.rounds == rc.rounds
    _assert_port_equal(a.nodes, b.nodes, "partial-vs-vector")
    _assert_port_equal(a.nodes, c.nodes, "partial-vs-full")
    assert [vm.out_stream for vm in a.nodes] == [[2 * (i + 1), 20 * (i + 1)] for i in range(6)]
    assert not hasattr(a.io_service, "svc_batches")
    assert b.io_service.svc_batches == 0 and b.io_service.scalar_calls == 12
    assert b.executive_stats()["svc_scalar_calls"] == 12
    assert a.executive_stats()["svc_scalar_calls"] == 0
    assert b.io_d2h_bytes == b.transfer_stats()["io_d2h_bytes"] > 0
    assert c.io_d2h_bytes == 0 and c.d2h > a.d2h


def test_vectorized_handler_one_batch_per_service():
    vec = _svc_fleet("vector", vectorized=True)
    scal = _svc_fleet("vector", vectorized=False)
    rv, rs = vec.run(max_rounds=30), scal.run(max_rounds=30)
    assert rv.rounds == rs.rounds
    _assert_port_equal(vec.nodes, scal.nodes, "vec-vs-scalar")
    svc = vec.io_service
    assert svc.syscalls == 2 * vec.n and svc.scalar_calls == 0
    assert svc.svc_batches == 2 < svc.syscalls
    assert scal.io_service.scalar_calls == 2 * scal.n
    t = vec.transfer_stats()
    assert t["io_syscalls"] == 2 * vec.n and t["io_svc_batches"] == svc.svc_batches


def test_vector_service_posts_ring_rules():
    """svc.post delivers through the mailbox rings and drops on a full ring
    or an out-of-range node (CAN's rule, not send's backpressure)."""
    fleet = FleetVM(CFG, n=2, executor="batched", io_mode="vector", device="cpu")

    def flood(rows, svc):
        for r in rows:
            for k in range(CFG.mbox_size + 2):
                svc.post(1, r.node, 100 + k)
            svc.post(99, r.node, 7)
        return None

    for node in fleet.nodes:
        node.svc_add("flood", flood, args=0, ret=0, vectorized=True)
    fleet.nodes[0].launch(fleet.nodes[0].load("flood 1 out"))
    fleet.nodes[1].launch(fleet.nodes[1].load("1 2 + out"))
    fleet.run(max_rounds=20)
    svc = fleet.io_service
    assert svc.posts == CFG.mbox_size and svc.post_drops == 3
    mbox = fleet.nodes[1].state.mbox.numpy()
    assert list(mbox[1::2][: CFG.mbox_size]) == [100 + k for k in range(CFG.mbox_size)]
    assert list(mbox[0::2][: CFG.mbox_size]) == [0] * CFG.mbox_size
    assert int(fleet.nodes[1].state.mbox_wr) == CFG.mbox_size


@pytest.mark.parametrize("executor", EXECUTORS)
def test_services_trio(tmp_path, executor):
    fleet = FleetVM(CFG, n=4, executor=executor, executive=ECFG, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    svcs = install_services(fleet.nodes, checkpoint_manager=mgr)
    svcs.can.subscribe(7, 3)
    for i, node in enumerate(fleet.nodes):
        node.launch(node.load(f"{10 + i} uart.write  {i} 7 can.send  {i} fs.save out"))
    res = fleet.run(max_rounds=40)
    assert all(s == "done" for s in res.statuses)
    assert svcs.uart.stream == [(i, 10 + i) for i in range(4)]
    assert svcs.uart.batches == 1 and svcs.uart.writes == 4
    assert svcs.fs.saves == 1 and svcs.fs.requests == 4
    assert mgr.latest_step() == 1
    for i, vm in enumerate(fleet.nodes):
        assert vm.out_stream == [10 + i, 1]
    tree, _ = mgr.restore({f"node{i}": {"tag": np.int32(0), "mem": np.zeros(CFG.mem_size, np.int32)}
                           for i in range(4)})
    assert [int(tree[f"node{i}"]["tag"]) for i in range(4)] == [0, 1, 2, 3]
    assert svcs.can.frames == 4 and svcs.can.deliveries == 4
    assert sorted(fleet.nodes[3].state.mbox.numpy()[1::2][:4]) == [0, 1, 2, 3]
    e = fleet.executive_stats()
    assert (e["syscalls"], e["svc_batches"], e["svc_scalar_calls"]) == (12, 3, 0)
    assert e["svc_posts"] == 4 and e["svc_post_drops"] == 0


# The trio through both packages' vectorized Executive fleets: uart.write
# and fs.save from two tasks of each node (a save shared by both), a CAN flood
# to a subscriber listed twice (past its mailbox ring) and to a node that
# does not exist, and a frame back the other way, each consumed by receive;
# ``probe`` pushes what the handlers called before it in its chunk did.
SVC_MAINS = [": flood 8 0 do i 7 can.send loop ;\n"
             "6 fs.save out 10 uart.write flood 3 fs.save out receive out out",
             "probe out 2 uart.write 4 fs.save out 21 8 can.send receive out out receive out out"]
SVC_SPAWNS = ((0, "3 0 do i 100 + uart.write loop", 1, 0), (1, "9 fs.save out", 0, 0))
SVC_SUBS = ((7, 1), (7, 1), (7, 5), (8, 0))


def _svc_scenario(fleet, executive, svcs):
    def probe(rows, svc):
        return [svcs.uart.writes + 100 * svcs.fs.saves] * len(rows)

    for node in fleet.nodes:
        node.svc_add("probe", probe, args=0, ret=1, vectorized=True)
    for can_id, node in SVC_SUBS:
        svcs.can.subscribe(can_id, node)
    _program(fleet.nodes, executive, SVC_MAINS, SVC_SPAWNS)
    return fleet.run(max_rounds=60)


def _svc_counters(fleet, svcs):
    e = fleet.executive_stats()
    e.pop("executor")
    return {**e, "uart": (svcs.uart.writes, svcs.uart.batches),
            "fs": (svcs.fs.saves, svcs.fs.requests), "can": (svcs.can.frames, svcs.can.deliveries)}


def _checkpoints(directory):
    """Every checkpoint on disk: its directory name, its extra and its
    leaves by name."""
    out = []
    for path in sorted(directory.glob("ckpt_*")):
        with np.load(path / "arrays.npz") as arrays:
            leaves = {k: arrays[k] for k in arrays.files}
        out.append((path.name, json.loads((path / "meta.json").read_text())["extra"], leaves))
    return out


@pytest.fixture(scope="module")
def jax_svc_run(tmp_path_factory):
    """The scenario through the JAX package's batched Executive fleet (the
    spawn-word scenario's round, already compiled at this width)."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    jf = JFleet(JCFG, n=len(SVC_MAINS), executor="batched", executive=JECFG)
    jsvcs = jservices.install_services(jf.nodes, JCheckpointManager(str(ckpt), keep=16))
    jres = _svc_scenario(jf, JExecutive(jf), jsvcs)
    return jf, jsvcs, jres, ckpt


@pytest.mark.parametrize("executor", EXECUTORS)
def test_syscall_plane_equals_jax_fleet(executor, jax_svc_run, tmp_path):
    """The vectorized syscall plane's gather, handler order, pops, pushes,
    resumes, fs.save ids and CAN posts (ring-full and out-of-range drops)
    land on the JAX fleet's bytes, streams, checkpoints and counters."""
    jf, jsvcs, jres, jckpt = jax_svc_run
    fleet = FleetVM(CFG, n=len(SVC_MAINS), executor=executor, executive=ECFG, device="cpu")
    svcs = install_services(fleet.nodes, CheckpointManager(str(tmp_path), keep=16))
    res = _svc_scenario(fleet, Executive(fleet), svcs)
    assert fleet.io_mode == jf.io_mode == "vector"
    assert res.rounds == jres.rounds and res.statuses == jres.statuses == ["done"] * 2
    _assert_states_equal(fleet.nodes, jf.nodes, executor)
    assert svcs.uart.stream == jsvcs.uart.stream
    assert _svc_counters(fleet, svcs) == _svc_counters(jf, jsvcs)
    mine, ref = _checkpoints(tmp_path), _checkpoints(jckpt)
    assert [(name, extra) for name, extra, _ in mine] == [(name, extra) for name, extra, _ in ref]
    for (name, _, a), (_, _, b) in zip(mine, ref):
        assert a.keys() == b.keys(), name
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    # The scenario reaches what it is for: shared batches, several saves,
    # and both of the post ring's drop rules.
    e = fleet.executive_stats()
    assert e["svc_batches"] < e["syscalls"] and svcs.fs.saves >= 2
    assert max(len(leaves) for _, _, leaves in mine) == 4          # two nodes' tag and mem
    assert e["svc_posts"] > 0 and e["svc_post_drops"] > 2 * 8 - CFG.mbox_size


def test_services_pin_the_reference_numbers():
    assert (services.SVC_UART, services.SVC_FS, services.SVC_CAN) == (
        jservices.SVC_UART, jservices.SVC_FS, jservices.SVC_CAN) == (56, 57, 58)
    nodes = [REXAVM(CFG, device="cpu") for _ in range(2)]
    jnodes = [JVM(JCFG, backend="oracle") for _ in range(2)]
    svcs, jsvcs = install_services(nodes), jservices.install_services(jnodes)
    for vm, jvm in zip(nodes, jnodes):
        assert vm.fios.table.numbers() == jvm.fios.table.numbers() == {
            "uart.write": 56, "can.send": 58}
        assert vm.fios.opcode("uart.write") == jvm.fios.opcode("uart.write") == FIOS_BASE + 56
        prog = "1 uart.write 2 3 can.send"
        assert np.array_equal(vm.state.cs.numpy()[vm.load(prog).start:],
                              np.asarray(jvm.state.cs)[jvm.load(prog).start:])
    assert svcs.fs is None and jsvcs.fs is None


def test_syscall_table_numbering_equals_reference():
    calls = [("a", {}), ("b", {"args": 1, "ret": 1}), ("pin", {"num": 9}), ("c", {}),
             ("a", {}), ("clash", {"num": 9}), ("a", {"num": 5}), ("oob", {"num": MAX_FIOS}),
             ("d", {"num": 3})]
    t, jt = SyscallTable(), JSyscallTable()
    for name, kw in calls:
        outs = []
        for table in (t, jt):
            try:
                outs.append(table.register(name, lambda: 0, **kw))
            except ValueError as e:
                outs.append(type(e))
        assert outs[0] == outs[1], (name, kw, outs)
    assert t.numbers() == jt.numbers() == {"a": 0, "b": 1, "pin": 9, "c": 2, "d": 3}
    assert t.entry_for_opcode(FIOS_BASE + 1).name == "b"
    assert [e and (e.name, e.args, e.ret, e.num, e.vectorized) for e in t.entries] == [
        e and (e.name, e.args, e.ret, e.num, e.vectorized) for e in jt.entries]
    full, jfull = SyscallTable(), JSyscallTable()
    for k in range(MAX_FIOS):
        full.register(f"s{k}", lambda: 0)
        jfull.register(f"s{k}", lambda: 0)
    for table in (full, jfull):
        with pytest.raises(RuntimeError):
            table.register("overflow", lambda: 0)


def test_fios_shim_forwards_to_svc_table():
    vm, jvm = REXAVM(CFG, device="cpu"), JVM(JCFG, backend="oracle")
    calls = []
    for node in (vm, jvm):
        with pytest.warns(DeprecationWarning):
            op0 = node.fios_add("first", lambda v: calls.append(v), args=1)
        with pytest.warns(DeprecationWarning):
            op1 = node.fios_add("second", lambda: 7, ret=1)
        assert (op0, op1) == (FIOS_BASE, FIOS_BASE + 1)
    assert vm.fios.by_name == jvm.fios.by_name == {"first": 0, "second": 1}
    assert vm.fios.table.numbers() == {"first": 0, "second": 1}
    assert vm.fios.entry_for_opcode(FIOS_BASE).name == "first"
    assert vm.fios.entries[1].ret == 1
    res = vm.eval("41 first second out")
    assert res.status == "done" and calls == [41] and vm.out_stream == [7]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        vm.svc_add("third", lambda: 1, ret=1)           # the non-deprecated path


# ---------------------------------------------------------------------------
# Admission and deadlines
# ---------------------------------------------------------------------------

def _log(ex):
    return [(a.node, a.task, a.prio, a.deadline, a.admitted, a.reason) for a in ex.log]


def _both_executives(energy=None):
    fleet = FleetVM(CFG, n=1, executor="batched", executive=ECFG, device="cpu")
    pe = Executive(fleet, energy=energy and EnergyModel(*energy))
    jnodes, _ = _jax_nodes(1)
    je = JExecutive(types.SimpleNamespace(nodes=jnodes), energy=energy and JEnergy(*energy))
    return fleet, pe, je


def test_admission_log_equals_reference():
    fleet, pe, je = _both_executives(energy=(1.0, 1.0))
    calls = [("1 out", {"e_cost": 0.6}), ("2 out", {"e_cost": 0.6}),
             ("3 out", {"deadline": 5, "duration_ms": 10}),
             ("4 out", {"deadline": 50, "duration_ms": 10}),
             ("5 out", {"prio": 3, "task": 2}), ("6 out", {"prio": 1, "task": 5})]
    for prog, kw in calls:
        assert pe.spawn(0, prog, **kw) == je.spawn(0, prog, **kw), (prog, kw)
    assert _log(pe) == _log(je)
    assert [a.reason for a in pe.log] == ["ok", "no-energy", "infeasible", "ok", "no-slot", "ok"]
    assert pe.spawns_admitted == je.spawns_admitted == 3
    assert pe.spawns_rejected == je.spawns_rejected == 3
    e = fleet.executive_stats()
    assert (e["spawns_admitted"], e["spawns_rejected"]) == (3, 3)
    assert pe.task_table(0) == je.task_table(0)
    assert pe.energy[0].level == je.energy[0].level


def test_admission_no_slot_equals_reference():
    fleet, pe, je = _both_executives()
    slots = [pe.spawn(0, "yield 1 out") for _ in range(CFG.max_tasks)]
    jslots = [je.spawn(0, "yield 1 out") for _ in range(CFG.max_tasks)]
    assert slots == jslots == list(range(1, CFG.max_tasks)) + [-1]
    assert _log(pe) == _log(je) and pe.log[-1].reason == "no-slot"


@pytest.mark.parametrize("prog,deadline,duration", [
    (": w 0 100 0 do 1 + loop drop ; w halt", 2, 0),          # WCET > deadline: infeasible
    (": w 0 100 0 do 1 + loop drop ; w halt", 10_000, 0),     # feasible
    (": w begin 1 drop again ; w", 2, 0),                     # unbounded: deadline-only
    (": w 0 100 0 do 1 + loop drop ; w halt", 2, 1),          # declared duration wins
])
def test_wcet_admission_equals_reference(prog, deadline, duration):
    fleet, pe, je = _both_executives()
    for ex in (pe, je):
        ex.spawn(0, "1 out", prio=0)
        ex.spawn(0, prog, deadline=deadline, duration_ms=duration)
    assert _log(pe) == _log(je)
    vm, jvm = fleet.nodes[0], je.nodes[0]
    entry, jentry = vm.load(prog).entry, jvm.load(prog).entry
    assert entry == jentry
    assert pe._wcet_ms(vm, entry) == je._wcet_ms(jvm, jentry)


def test_wcet_matches_verifier_bound():
    from repro_torch.analysis.verifier import analyze_vm

    fleet, pe, _ = _both_executives()
    vm = fleet.nodes[0]
    frame = vm.load(": w 0 50 0 do 1 + loop drop ; w halt")
    rep = analyze_vm(vm, entries=[(frame.entry, 0, 0, 0, 0)])
    assert rep.wcet is not None
    assert pe._wcet_ms(vm, frame.entry) == -(-rep.wcet * CFG.us_per_instr // 1000)


def test_spawn_on_a_live_fleet():
    """A spawn between runs of a started fleet syncs it and pushes it back
    (whole-state copies), and the task runs."""
    fleet, ex = _build("batched", ["5 sleep 1 out"])
    fleet.start()
    d2h, h2d = fleet.d2h, fleet.h2d
    assert ex.spawn(0, "2 out", prio=1) == 1
    assert (fleet.d2h, fleet.h2d) == (d2h + 1, h2d + 1)
    fleet.run(max_rounds=20)
    assert fleet.nodes[0].out_stream == [2, 1]


def test_task_deadline_misses_counted():
    mains = ["0 begin 1+ dup 3000 >= until out"]
    spawns = ((0, "0 begin 1+ dup 2000 >= until out", 1, 2),)
    totals = {}
    for executor in EXECUTORS:
        fleet, _ = _build(executor, mains, spawns)
        fleet.run(max_rounds=60)
        e = fleet.executive_stats()
        totals[executor] = (e["task_deadline_misses"], e["tasks_missed"])
        assert e["task_deadline_misses"] >= 1
        assert e["tasks_missed"] <= e["task_deadline_misses"]
    assert len(set(totals.values())) == 1, totals


def test_executive_and_obs_are_exclusive():
    from repro_torch.obs import ObsConfig

    with pytest.raises(ValueError):
        FleetVM(CFG, n=1, executive=ECFG, obs=ObsConfig(), device="cpu")
    with pytest.raises(ValueError):
        FleetVM(CFG, n=1, io_mode="bulk", device="cpu")


def test_executive_config_validation():
    for kw in ({"quantum": 0}, {"slices": 0}):
        with pytest.raises(ValueError):
            ExecutiveConfig(**kw)
        with pytest.raises(ValueError):
            JExecCfg(**kw)
    assert ECFG.steps_per_round == JECFG.steps_per_round == 64
    assert isinstance(hash(ECFG), int)
    assert FleetVM(CFG, n=1, device="cpu").io_mode == "partial"
    assert FleetVM(CFG, n=1, executive=ECFG, device="cpu").io_mode == "vector"


def test_metrics_executive_section():
    fleet, _ = _build("batched", ["1 out", "2 out"], ((0, "3 out", 1, 0),))
    fleet.run(max_rounds=20)
    m = fleet.metrics().as_dict()
    assert m["executive"]["enabled"] is True
    assert m["executive"]["task_switches"] > 0 and m["executive"]["spawns_admitted"] == 1
    jf = JFleet(JCFG, n=2, executor="batched", executive=JECFG)
    assert set(m["executive"]) == set(jf.executive_stats()) - {"executor"}
    assert set(fleet.transfer_stats()) == set(jf.transfer_stats())
    assert set(fleet.kernel_stats()) == set(jf.pallas_stats())
    plain = FleetVM(CFG, n=1, device="cpu").executive_stats()
    assert plain["enabled"] is False and plain["quantum"] == 0


def test_from_nodes_keeps_the_nodes():
    nodes = [REXAVM(CFG, seed=1 + i, device="cpu") for i in range(2)]
    fleet = FleetVM.from_nodes(nodes, executor="oracle", executive=ECFG)
    assert fleet.nodes == nodes and fleet.executor_kind == "oracle"
    assert fleet.io_mode == "vector"


def test_auto_executive_fleet_plans_the_elided_kernel():
    """Under executor="auto" the kernels carry the ExecutiveConfig: a fleet
    whose programs all verify and claim every word runs its micro-slices on
    the checks-elided interpreter and vmloop instance, byte-exact against
    the JAX reference round."""
    mains = ["0 begin 1+ dup 60 >= until out", "3 0 do i out loop"]
    spawns = ((0, "0 40 0 do 1+ loop out", 1, 500), (1, "0 30 0 do 1+ loop out", 1, 0))
    fleet, _ = _build("auto", mains, spawns)
    res = fleet.run(max_rounds=60)
    a = fleet.analysis_stats()
    assert (a["executor"], a["elide_checks"]) == ("cuda", True)
    assert fleet.kernels.executive is ECFG and fleet.kernels.interp.elide_checks
    assert fleet.kernel_stats()["exec_slices"] == ECFG.slices * res.rounds
    ref_nodes, obs = _reference(mains, res.rounds, spawns)
    _assert_states_equal(fleet.nodes, ref_nodes, "auto")
    assert fleet.executive_stats()["preemptions"] == obs["preemptions"] > 0
