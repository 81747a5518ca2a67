"""The port's sharded fleet (``FleetVM(mesh=)`` over a ``NodeMesh``) against
the meshless port and the JAX package.

The reference's own mesh tests (``tests/test_vm_fleet_sharded.py``) are the
contract: a mesh fleet equals the meshless fleet and ``reference_round``
byte for byte, each shard holds ``N / k`` rows, a fleet the mesh does not
divide replicates (spec ``()``), the run counts one ``h2d`` and one ``d2h``,
and the partial IO service moves only the suspended nodes' rows.  The JAX
side runs unsharded: the 64-node ring through ``reference_round`` over
``REXAVM(backend="jit")`` nodes (built once for the module), the rest over
``backend="oracle"`` nodes, which compile nothing.  The port runs on
``make_node_mesh(k, device="cpu")`` for k in 1, 2, 4 and 8: several shards
on one device, each with state of its own.
"""

import numpy as np
import pytest
import torch

from repro.config import VMConfig as JCfg
from repro.core.vm import REXAVM as JVM
from repro.core.vm import reference_round as jref_round

from repro_torch.config import VMConfig
from repro_torch.core.vm import FleetVM, vmstate as vms
from repro_torch.exec import Executive, ExecutiveConfig, install_services
from repro_torch.kernels.vmloop.ops import fleet_vmloop
from repro_torch.launch.mesh import NodeMesh, make_node_mesh
from repro_torch.obs import ObsConfig
from repro_torch.resilience import reshard_state
from repro_torch.serve import FleetServeMonitor, ServeStats
from repro_torch.sharding import leading_spec, make_fleet_rules

torch.set_num_threads(1)

JCFG = JCfg(cs_size=2048, steps_per_slice=64, mbox_size=4)
CFG = VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4)
KS = [1, 2, 4, 8]
N_RING = 64
PAIR = ["1 1 send receive swap . . halt", "receive swap . 1+ 0 send halt"]


def ring_program(i: int, n: int) -> str:
    if i == 0:
        return f"1 {1 % n} send receive swap . . halt"
    return f"receive swap . 1+ {(i + 1) % n} send halt"


def random_messaging(seed: int, n: int, rounds_of: int = 2) -> list[list[str]]:
    """The generator of tests/test_vm_fleet.py (TestRandomizedPrograms),
    destinations in [-1, n + 1], so some sends are dropped."""
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


ANN = (
    "array x { 10 20 30 40 } "
    "array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
    "array y { 0 0 0 0 } "
    "0 begin 1+ x w y 0 vecfold x y dotprod drop dup 30 >= until "
    "drop halt"
)
# Tasks, sleeps, messages across shards, rnd and the ANN: every engine's
# hand-back and the router in one fleet of 8 (2 nodes a shard at k = 4).
MIXED = [
    ": worker 3 sleep 7 5 send ; 0 0 $ worker task drop receive . . receive . . halt",
    "receive 1+ swap send 5 sleep 99 0 send halt",
    "0 100 0 do 1+ loop . 9 rnd . halt",
    ANN,
    "3 1 send 0 30 0 do 1+ loop . halt",
    "receive . . 12 0 send 12 99 send halt",
    ": spin 0 20 0 do 5 rnd + loop . ; spin halt",
    "0 40 0 do 1+ loop . halt",
]


def make_fleet(progs, executor="batched", mesh=None, **kw):
    where = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    fleet = FleetVM(CFG, n=len(progs), executor=executor, **where, **kw)
    for node, prog in zip(fleet.nodes, progs):
        node.launch(node.load(prog))
    return fleet


def make_reference(progs, backend="oracle"):
    nodes = [JVM(JCFG, backend=backend, seed=1 + i) for i in range(len(progs))]
    for node, prog in zip(nodes, progs):
        node.launch(node.load(prog))
    return nodes


def assert_equal_reference(fleet, ref, skip=()):
    for i, (a, b) in enumerate(zip(fleet.nodes, ref)):
        pa = vms.to_reference(a.state)
        for f in vms.VMState._fields:
            if f not in skip:
                assert np.array_equal(getattr(pa, f), np.asarray(getattr(b.state, f))), (i, f)


def assert_equal_port(a_nodes, b_nodes, ctx=""):
    for i, (a, b) in enumerate(zip(a_nodes, b_nodes)):
        for f, x, y in zip(vms.VMState._fields, a.state, b.state):
            assert torch.equal(x, y), (ctx, i, f)
        assert a.out_stream == b.out_stream, (ctx, i)


def assert_own_storage(S, k: int, n: int):
    """``S`` is k shards of n / k rows, no two sharing storage."""
    assert isinstance(S, vms.ShardedState) and len(S.shards) == k
    assert S.sizes == (n // k,) * k
    for f in vms.VMState._fields:
        ptrs = {getattr(sh, f).untyped_storage().data_ptr() for sh in S.shards}
        assert len(ptrs) == k, f


@pytest.fixture(scope="module")
def ring_reference():
    """The meshless port's 64-node ring and the reference's
    ``reference_round`` over jit nodes for as many rounds."""
    progs = [ring_program(i, N_RING) for i in range(N_RING)]
    base = make_fleet(progs)
    res = base.run(max_rounds=300)
    ref = make_reference(progs, backend="jit")
    for _ in range(res.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    return progs, base, res, ref, [vm.output() for vm in ref]     # output() drains a ring


# ---------------------------------------------------------------------------
# The reference's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
def test_pair_of_programs_mesh_equals_meshless_and_reference(k):
    """The reference's single-mesh pair (sharded at k <= 2, replicated
    above) against the meshless port and ``reference_round``."""
    meshed, plain = make_fleet(PAIR, mesh=make_node_mesh(k, device="cpu")), make_fleet(PAIR)
    r1, r2 = meshed.run(max_rounds=20), plain.run(max_rounds=20)
    assert r1.outputs == r2.outputs and r1.rounds == r2.rounds
    assert r1.statuses == r2.statuses == ["halt", "halt"]
    assert meshed.node_spec == (("node",) if k <= 2 else ())
    assert_equal_port(meshed.nodes, plain.nodes)
    ref = make_reference(PAIR)
    for _ in range(r1.rounds):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal_reference(meshed, ref, skip=("out", "outp"))
    assert r1.outputs == [vm.output() for vm in ref]


@pytest.mark.parametrize("n,k,spec", [(3, 1, ("node",)), (8, 8, ("node",)), (6, 8, ()),
                                      (6, 4, ())])
def test_node_spec(n, k, spec):
    """A divisible fleet shards its leading axis over "node"; a fleet the
    mesh does not divide keeps one full copy on the mesh's first device,
    and still runs."""
    mesh = make_node_mesh(k, device="cpu")
    fleet = make_fleet(["1 . halt"] * n, mesh=mesh)
    assert fleet.node_spec == spec == leading_spec(n, "node", make_fleet_rules(mesh))
    fleet.start()
    if spec:
        assert_own_storage(fleet._S, k, n)
    else:
        assert isinstance(fleet._S, vms.VMState) and fleet._S.pc.device == mesh.devices[0]
    assert fleet.run(max_rounds=10).outputs == ["1 "] * n


@pytest.mark.parametrize("k", KS)
def test_64_node_ring_byte_exact(k, ring_reference):
    """The 64-node ring over k shards: byte-exact with the meshless port
    and with ``reference_round`` over the reference's jit nodes, one
    ``h2d`` and one ``d2h``, N / k rows a shard in storage of its own."""
    progs, base, base_res, ref, ref_outputs = ring_reference
    fleet = make_fleet(progs, mesh=make_node_mesh(k, device="cpu"))
    fleet.start()
    assert_own_storage(fleet._S, k, N_RING)
    res = fleet.run(max_rounds=300)
    assert res.statuses == ["halt"] * N_RING
    assert res.outputs[0] == f"{N_RING - 1} {N_RING} "
    assert fleet.h2d == 1 and fleet.d2h == 1
    assert res.rounds == base_res.rounds and res.outputs == base_res.outputs
    assert_equal_port(fleet.nodes, base.nodes)
    assert_equal_reference(fleet, ref, skip=("out", "outp"))     # run() drained the rings
    assert res.outputs == ref_outputs
    stats = fleet.kernels.route.stats
    assert stats["rounds"] == res.rounds and stats["cross_device_chunks"] == 0
    assert stats["chunks"] == (k * res.rounds if k > 1 else 0)


def _partial_io_fleet(mesh):
    fl = FleetVM(CFG, n=8, **({"mesh": mesh} if mesh else {"device": "cpu"}))
    for i, node in enumerate(fl.nodes):
        if i < 2:
            node.dios_add("ready", np.array([0], np.int32))
            with pytest.warns(DeprecationWarning):
                node.fios_add("ping", lambda node=node: node.dios_write("ready", [1]))
            node.launch(node.load("ping 1000 1 ready await drop 5 . halt"))
        else:
            node.launch(node.load("0 50 0 do 1+ loop . halt"))
    return fl


@pytest.mark.parametrize("k", [2, 8])
def test_partial_io_moves_only_suspended_rows(k):
    """2 of 8 nodes suspend on a FIOS call: the service gathers and
    scatters exactly those rows across shards (the reference's
    PARTIAL_IO_SHARDED_OK), and the fleet equals the meshless one."""
    fl, base = _partial_io_fleet(make_node_mesh(k, device="cpu")), _partial_io_fleet(None)
    r, rb = fl.run(max_rounds=60), base.run(max_rounds=60)
    assert r.statuses == ["halt"] * 8 and r.outputs == rb.outputs
    svc = fl.io_service
    assert svc.services >= 1 and svc.nodes_serviced >= 2
    per_node = vms.state_nbytes(fl.nodes[0].state)
    assert fl.io_d2h_bytes == svc.nodes_serviced * per_node == base.io_d2h_bytes
    assert fl.io_h2d_bytes == fl.io_d2h_bytes
    assert fl.io_d2h_bytes < svc.services * 8 * per_node
    assert_equal_port(fl.nodes, base.nodes)


# ---------------------------------------------------------------------------
# The router across shards
# ---------------------------------------------------------------------------

# Nodes 1..7 (on three other shards) spray node 0's four-slot ring; node 1
# also sends to 99 (dropped).  The global (node, task) order decides who
# wins each round.
FAN_IN = (["12 0 do receive drop drop loop 1 . halt",
           "5 99 send " + " ".join(f"{v} 0 send" for v in range(4)) + " halt"]
          + [" ".join(f"{10 * i + v} 0 send" for v in range(4)) + " halt" for i in range(2, 8)])


@pytest.mark.parametrize("executor", ["batched", "cuda"])
def test_fan_in_to_a_full_mailbox_across_shards(executor):
    """Backpressure ranks by the global (node, task) order, not the shard
    order, and the out-of-range send is dropped: lock-step against the
    meshless port every round and the reference at the end."""
    fleet = make_fleet(FAN_IN, executor, mesh=make_node_mesh(4, device="cpu"))
    base = make_fleet(FAN_IN, executor)
    fleet.start()
    base.start()
    for _ in range(20):
        fleet.kernels.round(fleet._S, CFG.steps_per_slice)
        base.kernels.round(base._S, CFG.steps_per_slice)
        for x, y in zip(vms.to_host(fleet._S), base._S):
            assert torch.equal(x, y)
    fleet.sync()
    ref = make_reference(FAN_IN)
    for _ in range(20):
        jref_round(ref, JCFG.steps_per_slice)
    assert_equal_reference(fleet, ref)
    assert fleet.nodes[0].output() == "1 "


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("seed", [7, 11])
def test_random_messaging_on_four_shards(seed, n):
    """The randomized messaging programs under a 4-shard mesh (sharded at
    8 nodes, replicated at 3), lock-step against the reference."""
    for progs in random_messaging(seed, n):
        fleet, ref = make_fleet(progs, mesh=make_node_mesh(4, device="cpu")), make_reference(progs)
        assert fleet.node_spec == (("node",) if n == 8 else ())
        fleet.start()
        for _ in range(12):
            fleet.kernels.round(fleet._S, CFG.steps_per_slice)
        fleet.sync()
        for _ in range(12):
            jref_round(ref, JCFG.steps_per_slice)
        assert_equal_reference(fleet, ref)


def test_route_obs_reduces_drops_and_depth_across_shards():
    from repro_torch.core.vm.routing import build_router

    mesh = make_node_mesh(4, device="cpu")
    a, b = make_fleet(FAN_IN, mesh=mesh), make_fleet(FAN_IN)
    a.start()
    b.start()
    ra, rb = build_router(CFG, obs=True), build_router(CFG, obs=True)
    for _ in range(3):
        a.kernels.executor.run_slice_batched(a._S, CFG.steps_per_slice)
        b.kernels.executor.run_slice_batched(b._S, CFG.steps_per_slice)
        _, pa, (da, ha) = ra(a._S)
        _, pb, (db, hb) = rb(b._S)
        assert isinstance(pa, tuple) and torch.equal(torch.cat(pa), pb)
        assert (int(da), int(ha)) == (int(db), int(hb))
    assert int(hb) == CFG.mbox_size


# ---------------------------------------------------------------------------
# Every engine on a mesh equals its meshless run
# ---------------------------------------------------------------------------

def _run_pair(executor, progs=MIXED, k=4, **kw):
    """The fleet on a k-shard mesh, then meshless: each ``(fleet, result,
    trace_stats)``, the trace engine's counters read before the next run
    (the engine is shared by every fleet of one VMConfig)."""
    out = []
    for mesh in (make_node_mesh(k, device="cpu"), None):
        fleet = make_fleet(progs, executor, mesh=mesh, **kw)
        res = fleet.run(max_rounds=200)
        out.append((fleet, res, fleet.trace_stats()))
    return out


@pytest.mark.parametrize("executor", ["batched", "cuda", "oracle", "trace", "auto"])
def test_engine_on_mesh_equals_meshless(executor):
    (fm, rm, tm), (fb, rb, tb) = _run_pair(executor)
    assert fm.node_spec == ("node",)
    assert rm.statuses == ["halt"] * len(MIXED)
    assert rm.rounds == rb.rounds and rm.outputs == rb.outputs and (rm.steps == rb.steps).all()
    assert_equal_port(fm.nodes, fb.nodes, executor)
    assert fm.kernel_stats() == fb.kernel_stats()
    assert fm.transfer_stats() == fb.transfer_stats()
    if executor == "cuda":
        assert fm.kernel_stats()["bail_hist"]["rnd"] >= 2
    if executor == "auto":
        assert fm.analysis_stats() == fb.analysis_stats()
    for key in ("spec_steps", "guard_exits", "total_steps", "specialized_frac", "exec_slices"):
        assert tm[key] == tb[key], key


def test_cuda_message_bound_rounds_on_mesh():
    """service_every=8 (``FleetKernels.rounds_aux``) on 8 shards of the ring."""
    progs = [ring_program(i, 16) for i in range(16)]
    out = []
    for mesh in (make_node_mesh(8, device="cpu"), None):
        fleet = make_fleet(progs, "cuda", mesh=mesh)
        out.append((fleet, fleet.run(max_rounds=100, service_every=8)))
    (fm, rm), (fb, rb) = out
    assert rm.rounds == rb.rounds and rm.outputs == rb.outputs
    assert_equal_port(fm.nodes, fb.nodes)
    assert fm.kernel_stats() == fb.kernel_stats()


EXEC_MAINS = [
    "receive . . 3 uart.write",
    "5 0 do i out loop",
    ": w 2 sleep 9 out ;\n0 0 $ w task drop yield 4 out",
    "1 sleep taskid out ms out",
    "0 begin 1+ dup 200 >= until out",
    "42 7 can.send 11 uart.write",
    "receive . .",
    "1 2 + out",
]
EXEC_SPAWNS = ((0, ": bg 2 0 do 100 out loop ;\nbg", 1, 0),
               (4, "0 begin 1+ dup 150 >= until out", 1, 0),
               (7, "200 out", 3, 0))


def _exec_fleet(executor, mesh):
    where = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    fleet = FleetVM(CFG, n=len(EXEC_MAINS), executor=executor,
                    executive=ExecutiveConfig(quantum=16, slices=4), **where)
    services = install_services(fleet.nodes)
    for node in (0, 6):
        services.can.subscribe(7, node)
    for node, prog in zip(fleet.nodes, EXEC_MAINS):
        node.launch(node.load(prog))
    ex = Executive(fleet)
    for node, prog, prio, deadline in EXEC_SPAWNS:
        ex.spawn(node, prog, prio=prio, deadline=deadline)
    return fleet, services


@pytest.mark.parametrize("executor", ["batched", "cuda"])
def test_executive_on_mesh_equals_meshless(executor):
    """The Executive's micro-slices, the vectorized syscall plane (UART and
    a CAN post from one shard to two others) and the spawns on a 4-shard
    mesh, against the meshless fleet."""
    (fm, sm), (fb, sb) = _exec_fleet(executor, make_node_mesh(4, device="cpu")), \
        _exec_fleet(executor, None)
    rm, rb = fm.run(max_rounds=60), fb.run(max_rounds=60)
    assert rm.rounds == rb.rounds and rm.outputs == rb.outputs
    assert_equal_port(fm.nodes, fb.nodes, executor)
    assert sm.uart.stream == sb.uart.stream and sm.can.deliveries == sb.can.deliveries == 2
    assert fm.executive_stats() == fb.executive_stats()
    assert fm.executive_stats()["svc_posts"] == 2
    assert fm.transfer_stats() == fb.transfer_stats()


@pytest.mark.parametrize("executor", ["batched", "cuda"])
def test_obs_metrics_on_mesh_equal_meshless(executor):
    """The telemetry plane's counters and every ``metrics()`` section but
    the wall-clock latency equal the meshless run's."""
    obs = ObsConfig(trace=True, deadline_ms=1, time_rounds=True)
    (fm, rm, _), (fb, rb, _) = _run_pair(executor, obs=obs)
    assert_equal_port(fm.nodes, fb.nodes, executor)
    mm, mb = fm.metrics().as_dict(), fb.metrics().as_dict()
    mm.pop("latency")
    mb.pop("latency")
    assert mm == mb
    assert mm["counters"]["mbox_high"] >= 1 and mm["counters"]["instructions"] == int(rm.steps.sum())


def test_serve_monitor_on_mesh_equals_meshless():
    """``FleetServeMonitor(mesh=)`` no longer raises, and over a fixed
    ServeStats sequence it reports and counts as the meshless monitor."""
    mons = [FleetServeMonitor(n=8, cfg=CFG, executor=ex, **where)
            for ex, where in (("cuda", {"mesh": make_node_mesh(4, device="cpu")}),
                              ("cuda", {"device": "cpu"}))]
    for step in range(4):
        stats = ServeStats(prefill_tokens=32 * (step + 1), decode_tokens=8 * step, steps=step + 1)
        for mon in mons:
            mon(stats)
    (a, b) = mons
    assert a.fleet.node_spec == ("node",)
    assert a.reports() == b.reports() == [[0, 8, 8, 8]] * 8
    ma, mb = a.metrics().as_dict(), b.metrics().as_dict()
    ma.pop("latency")
    mb.pop("latency")
    assert ma == mb
    with pytest.raises(ValueError, match="mesh or device"):
        FleetServeMonitor(n=8, mesh=make_node_mesh(2, device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# The pieces: the mesh, the state, the kernel op, resharding
# ---------------------------------------------------------------------------

def test_node_mesh_and_placement():
    mesh = make_node_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.axis_names == ("node",)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_node_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        NodeMesh(())
    with pytest.raises(ValueError, match="mesh or device"):
        FleetVM(CFG, n=4, mesh=mesh, device="cpu")


def test_take_and_put_nodes_across_shards():
    fleet = make_fleet([ring_program(i, 8) for i in range(8)], mesh=make_node_mesh(4, "cpu"))
    fleet.start()
    S = fleet._S
    whole = vms.to_host(S)
    idx = [7, 0, 3, 4]
    rows = vms.take_nodes(S, idx, device="cpu")
    for x, y in zip(rows, whole):
        assert torch.equal(x, y[idx])
    bumped = vms.VMState(*[x + 1 for x in rows])
    vms.put_nodes(S, idx, bumped)
    after = vms.to_host(S)
    keep = [1, 2, 5, 6]
    for x, y, u in zip(after, whole, bumped):
        assert torch.equal(x[idx], u) and torch.equal(x[keep], y[keep])
    assert vms.state_nbytes(S) == vms.state_nbytes(whole)
    assert (vms.field_to_host(S, "pc") == after.pc.numpy()).all()


def test_fleet_vmloop_launches_once_a_shard():
    """``fleet_vmloop(..., mesh=)`` over a sharded state equals the plain
    call, with per-shard rows and budgets and a global budget split at the
    shard boundaries."""
    from repro_torch.kernels.vmloop import vmloop as kmod

    progs = [ANN, "0 100 0 do 1+ loop . halt", "9 rnd . halt", ANN] * 2
    mesh = make_node_mesh(4, device="cpu")
    a, b = make_fleet(progs, "cuda", mesh=mesh), make_fleet(progs, "cuda")
    a.start()
    b.start()
    for sh in vms.shards_of(a._S) + vms.shards_of(b._S):
        a.kernels.interp.schedule(sh)
    budget = torch.arange(8, dtype=torch.int32) * 7
    calls = kmod.run_core
    seen = []
    kmod.run_core = lambda *x, **kw: seen.append(1) or calls(*x, **kw)
    try:
        _, n_a, bail_a, op_a = fleet_vmloop(a._S, 0, CFG, budget=budget, mesh=mesh)
    finally:
        kmod.run_core = calls
    _, n_b, bail_b, op_b = fleet_vmloop(b._S, 0, CFG, budget=budget)
    assert len(seen) == 4 and len(n_a) == 4
    assert torch.equal(torch.cat(n_a), n_b) and torch.equal(torch.cat(op_a), op_b)
    for x, y in zip(vms.to_host(a._S), b._S):
        assert torch.equal(x, y)
    rows = [torch.tensor([1], dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), None]
    _, n_r, _, _ = fleet_vmloop(a._S, 16, CFG, rows=rows, mesh=mesh)
    assert [x.shape[0] for x in n_r] == [1, 0, 2, 2]
    with pytest.raises(ValueError, match="mesh"):
        fleet_vmloop(a._S, 16, CFG)


def test_reshard_state_round_trips():
    """A fleet state from 8 shards to 4 to 1 and back to the host, equal at
    every step; a dict of tensors likewise, a tensor the mesh does not
    divide kept whole."""
    fleet = make_fleet([ring_program(i, 8) for i in range(8)], mesh=make_node_mesh(8, "cpu"))
    fleet.start()
    whole = vms.to_host(fleet._S)
    s4 = reshard_state(fleet._S, make_node_mesh(4, device="cpu"))
    assert_own_storage(s4, 4, 8)
    s1 = reshard_state(s4, make_node_mesh(1, device="cpu"))
    assert_own_storage(s1, 1, 8)
    for x, y in zip(vms.to_host(s1), whole):
        assert torch.equal(x, y)
    tree = {"w": torch.arange(24).reshape(8, 3), "odd": torch.arange(6)}
    t4 = reshard_state(tree, make_node_mesh(4, device="cpu"))
    assert len(t4["w"]) == 4 and t4["w"][1].shape == (2, 3) and t4["odd"].shape == (6,)
    back = reshard_state(t4, make_node_mesh(1, device="cpu"))
    assert all(torch.equal(torch.cat(back[k]), tree[k]) for k in tree)
