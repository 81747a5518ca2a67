"""The port's CUDA kernels on the card, each against its plain version:
vmloop byte-identical over the per-opcode sweep and random node states
(and the fleet's ``executor="cuda"`` identical to ``executor="batched"``),
fixmatmul bitwise equal (the streaming kernel at every decode batch
M = 1..16 and shape, ragged, misaligned and at extreme codes, one launch
a call; the tiled kernel above), flash attention within 1e-4 in f32 (the
FP32 kernel) and 2e-2 in bf16 (the tensor-core kernel, one bf16 step of
the output and of p; head_dim 128 causal without a window at query groups
of 1, 9 and 48 among the shapes), a qwen2-moe SMOKE decode step on the
int8 KV cache with int8 weights against the CPU, flash's HD_PAD 64
instance at zamba2's shared block and whisper's encoder (Sk 1500,
non-causal) and decoder, fixmatmul at the decode shapes of zamba2,
whisper and internvl2, and those three SMOKE configs' quantized decode
against the CPU, rwkv6_scan within 1e-4 (f32) and 1e-2 (bf16 ``out``)
of the largest value on all three routes (the decode kernel at one step,
also against its closed form and in an in-place chain, the one-block
kernel at one chunk, the two passes at two or more, and the kernels held
against each other), with its state written in place or not, lut_sigmoid
bitwise equal; vmloop
also over row lists and per-row budgets and at any block, and the
fleet's hand-back of declined words
byte-identical to ``executor="batched"``; vmloop's counting instance
(``obs=True``) against its plain version, states and histograms, over the
same inputs, and the fleet's ``executor="cuda"`` with obs against
``executor="batched"`` with obs, bin for bin; vmloop's checks-elided
instance (``elide_checks=True``) against its plain version, and a
verified ``FleetVM(executor="auto")`` on it, byte-identical to the checked
``executor="cuda"`` fleet; the Executive round (``ExecutiveConfig``) on
the kernel and under "auto", byte-identical to the batched Executive
fleet with equal counters; the trace-JIT fleet (the kernel as its tail
at per-node budgets) byte-identical to ``executor="cuda"``, and the
single-node ``"cuda"`` and ``"trace"`` backends to the Oracle; flash
attention's backward kernel within 1e-4 (f32) and 1e-2 (bf16) of its plain
version relative to the plain version's largest value, at the shapes of
``chip_smoke.py`` phase 9 (a) and on strided views (bf16 on the
tensor-core kernels, whose launches are counted, f32 on the FP32 ones;
two bf16 calls give the same bits), the forward's
log-sum-exp against its plain version, and ``ops.attention``'s
``FlashAttention`` against autograd through the plain attention; a CUDA
tensor never takes the
plain version (each launch counter grows), and no kernel without a
backward runs on inputs that require grad; rwkv6_scan's backward kernels
within 1e-4 (f32) and 1e-2 (bf16) of autograd through the plain version,
deterministic, and an rwkv6 SMOKE train step on them equal to the CPU's.
Needs an
NVIDIA GPU with nvcc; every test here skips without one.

Run on the card with ``python -m pytest tests/test_torch_cuda.py``.
"""

import collections
import importlib

import pytest
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import FleetVM, vmstate as vms
from repro_torch.kernels.vmloop import check, vmloop as kmod
from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref
from repro_torch.kernels.flashattn import flash_attention
from repro_torch.kernels.flashattn.flashattn import BWD_KERNELS, BWD_TC_KERNELS
from repro_torch.kernels.flashattn.ref import flash_attention_ref
from repro_torch.kernels.lutact.ref import lut_sigmoid_ref
from repro_torch.kernels.rwkv6_scan.ref import decode_ref, rwkv6_scan_ref
from repro_torch.kernels.vmloop.ref import core_of, vmloop_ref

fmod = importlib.import_module("repro_torch.kernels.fixmatmul.fixmatmul")
lmod = importlib.import_module("repro_torch.kernels.lutact.lutact")
rmod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")

pytestmark = pytest.mark.cuda

CFGS = [VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4), VMConfig()]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(S, cfg, steps):
    P = vms.clone(S)
    launches = kmod.vmloop_call.launches
    _, *k = kmod.vmloop_call(core_of(S), steps, cfg)
    _, *p = vmloop_ref(P, steps, cfg)
    torch.cuda.synchronize()
    assert kmod.vmloop_call.launches == launches + 1
    for name, a, b in zip(("n_exec", "bailed", "bail_op"), k, p):
        assert torch.equal(a, b), name
    assert check.max_abs_diff(S, P) == (0, [])
    return k


@pytest.mark.parametrize("cfg", CFGS, ids=["small", "default"])
def test_kernel_sweep_matches_plain_version(cfg, cuda):
    pairs, S = check.sweep_states(cfg, cuda)
    n_exec, bailed, _ = _kernel_vs_plain(S, cfg, cfg.steps_per_slice)
    for (word, _), n, b in zip(pairs, n_exec.tolist(), bailed.tolist()):
        if word in ("task", "rnd", "fios/trap"):
            assert b == 1, word


@pytest.mark.parametrize("cfg", CFGS, ids=["small", "default"])
def test_kernel_random_states_match_plain_version(cfg, cuda):
    _kernel_vs_plain(check.random_states(cfg, 512, 3, cuda), cfg, 64)


def test_fleet_cuda_equals_batched(cuda):
    cfg = CFGS[0]
    n = 64

    def ring(i):
        return (f"1 {1 % n} send receive swap . . halt" if i == 0
                else f"receive swap . 1+ {(i + 1) % n} send 7 rnd drop halt")

    out = {}
    for executor in ("cuda", "batched"):
        fleet = FleetVM(cfg, n=n, executor=executor, device=cuda)
        for i, node in enumerate(fleet.nodes):
            node.launch(node.load(ring(i)))
        res = fleet.run(max_rounds=300, service_every=4)
        assert res.statuses == ["halt"] * n
        out[executor] = (res, vms.stack_states([vm.state for vm in fleet.nodes]), fleet)
    (rc, Sc, fc), (rb, Sb, _) = out["cuda"], out["batched"]
    assert rc.outputs == rb.outputs and rc.rounds == rb.rounds
    assert check.max_abs_diff(Sc, Sb) == (0, [])
    stats = fc.kernel_stats()
    assert stats["kernel_steps"] > 0 and stats["bail_hist"].get("rnd", 0) > 0


def _rows_cases(n, steps, dev):
    g = torch.Generator().manual_seed(n)
    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.randperm(n, generator=g).to(**i32)
    return {
        "budget_only": (None, torch.randint(-3, steps + 5, (n,), generator=g).to(**i32)),
        "zero_budgets": (None, torch.zeros(n, **i32)),
        "rows_skip_nodes": (perm[: n // 3].sort().values, None),
        "rows_ragged_budget": (perm[: n - 5], torch.randint(0, 9, (n - 5,), generator=g).to(**i32)),
        "rows_outside_fleet": (torch.tensor([n + 3, -1, 0, n - 1], **i32),
                               torch.tensor([5, 5, 2, 7], **i32)),
    }


@pytest.mark.parametrize("case", ["budget_only", "zero_budgets", "rows_skip_nodes",
                                  "rows_ragged_budget", "rows_outside_fleet"])
def test_kernel_rows_and_budget_match_plain_version(case, cuda):
    """The kernel over a row list and per-row budgets, on 203 random nodes
    (a quarter of them not ST_RUN; no multiple of any block) and on the
    sweep, against the plain version."""
    cfg = CFGS[0]
    for S in (check.random_states(cfg, 203, 4, cuda), check.sweep_states(cfg, cuda)[1]):
        N = S.pc.shape[0]
        if N == 203:
            S.tstatus[torch.arange(0, N, 4, device=cuda), S.cur[::4].long()] = 7
        rows, budget = _rows_cases(N, cfg.steps_per_slice, cuda)[case]
        P = vms.clone(S)
        launches = kmod.vmloop_call.launches
        _, *k = kmod.vmloop_call(core_of(S), cfg.steps_per_slice, cfg, rows=rows, budget=budget)
        _, *p = kmod.run_core(core_of(P), kmod._tables(None, cuda)[0], cfg.steps_per_slice, cfg,
                              rows=rows, budget=budget)
        torch.cuda.synchronize()
        assert kmod.vmloop_call.launches == launches + 1
        for name, a, b in zip(("n_exec", "bailed", "bail_op"), k, p):
            assert torch.equal(a, b), name
        assert check.max_abs_diff(S, P) == (0, [])


@pytest.mark.parametrize("block", [1, 3, 7, 32])
def test_kernel_any_block_matches_plain_version(block, cuda, monkeypatch):
    """Blocks of 1 to 32 nodes over 101 nodes (ragged last block)."""
    cfg = CFGS[1]
    S = check.random_states(cfg, 101, 6, cuda)
    P = vms.clone(S)
    monkeypatch.setattr(kmod, "nodes_per_block", lambda rows, sms: block)
    _, *k = kmod.vmloop_call(core_of(S), 64, cfg)
    _, *p = vmloop_ref(P, 64, cfg)
    torch.cuda.synchronize()
    for name, a, b in zip(("n_exec", "bailed", "bail_op"), k, p):
        assert torch.equal(a, b), name
    assert check.max_abs_diff(S, P) == (0, [])


HANDBACK = {
    "task_then_rnd": (": w 3 . end ; 0 0 $ w task drop 7 rnd . halt", 2),
    "rnd_every_other": ("0 9 0 do 3 rnd drop 5 rnd drop 1+ loop . halt", 18),
    "exception_after_handback": (
        ": h 42 . ; $ h exception divbyzero catch 0= if 7 rnd 0 / drop endif 1 . halt", 1),
    "ring": (None, 1),
}


@pytest.mark.parametrize("case", sorted(HANDBACK))
def test_fleet_handback_equals_batched(case, cuda):
    """executor="cuda" hands each declined word to the interpreter and
    resumes the kernel after it: byte-identical to executor="batched", the
    interpreter running only the declined instructions."""
    cfg = CFGS[0]
    n = 48
    text, declined = HANDBACK[case]

    def prog(i):
        if text is not None:
            return text
        return (f"1 {1 % n} send receive swap . . halt" if i == 0
                else f"receive swap . 1+ {(i + 1) % n} send 7 rnd drop halt")

    out = {}
    for executor in ("cuda", "batched"):
        fleet = FleetVM(cfg, n=n, executor=executor, device=cuda)
        for i, node in enumerate(fleet.nodes):
            node.launch(node.load(prog(i)))
        res = fleet.run(max_rounds=300, service_every=3)
        assert res.statuses == ["halt"] * n
        out[executor] = (res, vms.stack_states([vm.state for vm in fleet.nodes]), fleet)
    (rc, Sc, fc), (rb, Sb, _) = out["cuda"], out["batched"]
    assert rc.outputs == rb.outputs and rc.rounds == rb.rounds
    assert check.max_abs_diff(Sc, Sb) == (0, [])
    stats = fc.kernel_stats()
    assert stats["fallback_steps"] == declined * (n if text is not None else n - 1)
    assert stats["kernel_steps"] + stats["fallback_steps"] == stats["total_steps"]


def _counting_vs_plain(S, cfg, steps, rows=None, budget=None):
    """The counting instance against its plain version: states, n_exec /
    bailed / bail_op and op_hist equal, one launch of the counting
    instance."""
    P = vms.clone(S)
    launches, obs = kmod.vmloop_call.launches, kmod.vmloop_call.obs_launches
    _, *k = kmod.vmloop_call(core_of(S), steps, cfg, rows=rows, budget=budget, obs=True)
    _, *p = kmod.run_core(core_of(P), kmod._tables(None, S.pc.device)[0], steps, cfg,
                          rows=rows, budget=budget, obs=True)
    torch.cuda.synchronize()
    assert kmod.vmloop_call.launches == launches + 1 and kmod.vmloop_call.obs_launches == obs + 1
    for name, a, b in zip(("n_exec", "bailed", "bail_op", "op_hist"), k, p):
        assert torch.equal(a, b), name
    assert torch.equal(k[3].sum(dim=1), k[0])
    assert check.max_abs_diff(S, P) == (0, [])
    return k


@pytest.mark.parametrize("cfg", CFGS, ids=["small", "default"])
def test_counting_instance_matches_plain_version(cfg, cuda):
    """The sweep (every word, FIOS, INT_MIN operands) and 512 random
    nodes (invalid pcs and reserved tags included)."""
    _counting_vs_plain(check.sweep_states(cfg, cuda)[1], cfg, cfg.steps_per_slice)
    _counting_vs_plain(check.random_states(cfg, 512, 8, cuda), cfg, 64)


@pytest.mark.parametrize("case", ["budget_only", "zero_budgets", "rows_skip_nodes",
                                  "rows_ragged_budget", "rows_outside_fleet"])
def test_counting_instance_rows_and_budget(case, cuda):
    """Row lists with per-row budgets: each row's histogram comes back in
    row order (rows outside the fleet read 0)."""
    cfg = CFGS[0]
    S = check.random_states(cfg, 203, 9, cuda)
    rows, budget = _rows_cases(203, cfg.steps_per_slice, cuda)[case]
    _counting_vs_plain(S, cfg, cfg.steps_per_slice, rows=rows, budget=budget)


@pytest.mark.parametrize("block", [1, 3, 7, 32])
def test_counting_instance_any_block(block, cuda, monkeypatch):
    """Blocks of 1 to 32 nodes over 101 nodes: the last block is ragged, so
    its copy-out covers fewer rows than threads."""
    cfg = CFGS[1]
    monkeypatch.setattr(kmod, "nodes_per_block", lambda rows, sms: block)
    _counting_vs_plain(check.random_states(cfg, 101, 10, cuda), cfg, 64)


@pytest.mark.parametrize("case", ["task_then_rnd", "ring"])
def test_fleet_cuda_obs_equals_batched_obs(case, cuda):
    """executor="cuda" with obs (the counting instance on every pass, the
    hand-backs binned by the interpreter) against executor="batched" with
    obs: every bin, the mailbox and deadline counters, and the states; the
    counting instance ran."""
    from repro_torch.obs import ObsConfig

    cfg = CFGS[0]
    n = 48
    text, _ = HANDBACK[case]

    def prog(i):
        if text is not None:
            return text
        return (f"1 {1 % n} send receive swap . . halt" if i == 0
                else f"receive swap . 1+ {(i + 1) % n} send 7 rnd drop halt")

    out = {}
    obs_launches = kmod.vmloop_call.obs_launches
    for executor in ("cuda", "batched"):
        fleet = FleetVM(cfg, n=n, executor=executor, device=cuda,
                        obs=ObsConfig(trace=True, deadline_ms=1))
        for i, node in enumerate(fleet.nodes):
            node.launch(node.load(prog(i)))
        res = fleet.run(max_rounds=300)
        assert res.statuses == ["halt"] * n
        out[executor] = (fleet.metrics().as_dict(), vms.stack_states([vm.state for vm in fleet.nodes]))
    assert kmod.vmloop_call.obs_launches > obs_launches
    (mc, Sc), (mb, Sb) = out["cuda"], out["batched"]
    for key in ("op_retired", "instructions", "mbox_high", "mbox_drops", "io_susp",
                "deadline_miss", "rounds_observed"):
        assert mc["counters"][key] == mb["counters"][key], key
    assert mc["counters"]["deopts"] == mc["pallas"]["bailed_node_rounds"] > 0
    assert check.max_abs_diff(Sc, Sb) == (0, [])


def _elided_vs_plain(S, cfg, steps, rows=None, budget=None):
    """The checks-elided instance against its plain version: states and
    n_exec / bailed / bail_op equal, one launch of the elided instance."""
    P = vms.clone(S)
    launches, elided = kmod.vmloop_call.launches, kmod.vmloop_call.elide_launches
    _, *k = kmod.vmloop_call(core_of(S), steps, cfg, rows=rows, budget=budget, elide_checks=True)
    _, *p = kmod.run_core(core_of(P), kmod._tables(None, S.pc.device)[0], steps, cfg,
                          rows=rows, budget=budget, elide_checks=True)
    torch.cuda.synchronize()
    assert kmod.vmloop_call.launches == launches + 1
    assert kmod.vmloop_call.elide_launches == elided + 1
    for name, a, b in zip(("n_exec", "bailed", "bail_op"), k, p):
        assert torch.equal(a, b), name
    assert check.max_abs_diff(S, P) == (0, [])


@pytest.mark.parametrize("cfg", CFGS, ids=["small", "default"])
def test_elided_instance_matches_plain_version(cfg, cuda):
    """The sweep, 512 random nodes (mostly unverifiable: stack pointers
    leave their stacks, every index clamped) and a row list with budgets."""
    _elided_vs_plain(check.sweep_states(cfg, cuda)[1], cfg, cfg.steps_per_slice)
    R = check.random_states(cfg, 512, 14, cuda)
    _elided_vs_plain(R, cfg, 64)
    assert bool(((R.dsp < 0) | (R.dsp > cfg.ds_size)).any())
    rows, budget = _rows_cases(203, cfg.steps_per_slice, cuda)["rows_ragged_budget"]
    _elided_vs_plain(check.random_states(cfg, 203, 15, cuda), cfg, cfg.steps_per_slice, rows, budget)


def test_vmloop_call_refuses_obs_with_elided_checks(cuda):
    core = core_of(check.random_states(CFGS[0], 4, 0, cuda))
    launches = kmod.vmloop_call.launches
    with pytest.raises(ValueError, match="elide_checks"):
        kmod.vmloop_call(core, 64, CFGS[0], obs=True, elide_checks=True)
    assert kmod.vmloop_call.launches == launches


def test_auto_fleet_runs_the_elided_instance(cuda):
    """A verified 64-node ring (no declined word) under executor="auto"
    plans ("cuda", elided), launches only the elided instance, and ends
    byte-identical to the checked executor="cuda" fleet."""
    cfg = CFGS[0]
    n = 64

    def ring(i):
        return (f"1 {1 % n} send receive swap . . halt" if i == 0
                else f"receive swap . 1+ {(i + 1) % n} send halt")

    out = {}
    for executor in ("cuda", "auto"):
        fleet = FleetVM(cfg, n=n, executor=executor, device=cuda)
        for i, node in enumerate(fleet.nodes):
            node.launch(node.load(ring(i)))
        launches, elided = kmod.vmloop_call.launches, kmod.vmloop_call.elide_launches
        res = fleet.run(max_rounds=300, service_every=4)
        assert res.statuses == ["halt"] * n
        ran = (kmod.vmloop_call.launches - launches, kmod.vmloop_call.elide_launches - elided)
        out[executor] = (res, vms.stack_states([vm.state for vm in fleet.nodes]), fleet, ran)
    (rc, Sc, _, ran_c), (ra, Sa, fa, ran_a) = out["cuda"], out["auto"]
    a = fa.analysis_stats()
    assert (a["executor"], a["elide_checks"], a["predicted_bail_words"]) == ("cuda", True, [])
    assert ran_c[0] > 0 and ran_c[1] == 0
    assert ran_a[0] == ran_a[1] > 0
    assert ra.outputs == rc.outputs and ra.rounds == rc.rounds
    assert check.max_abs_diff(Sa, Sc) == (0, [])
    assert fa.kernel_stats()["bail_hist"] == {}


def _executive_fleet(executor, cfg, dev, declined: bool, n=16):
    """A small Executive fleet: every node a bounded loop and a spawned
    prio-1 task that outlives its quanta.  With ``declined`` node 0 runs
    the ``task`` word inside a quantum and the spawned tasks write to the
    UART service (words the kernel hands back); without, every word is the
    kernel's, so "auto" plans the checks-elided kernel."""
    from repro_torch.exec import Executive, ExecutiveConfig, install_services

    fleet = FleetVM(cfg, n=n, executor=executor, device=dev,
                    executive=ExecutiveConfig(quantum=16, slices=4))
    svcs = install_services(fleet.nodes)
    ex = Executive(fleet)
    for i, node in enumerate(fleet.nodes):
        main = (": w 3 0 do 7 out loop ;\n1 0 $ w task out 5 out" if declined and i == 0
                else f"0 begin 1+ dup {20 + i} >= until out")
        node.launch(node.load(main))
        task = f"0 {10 + i} 0 do 1+ loop " + ("uart.write" if declined else "out")
        assert ex.spawn(i, task, prio=1, deadline=1000) > 0
    return fleet, svcs


@pytest.mark.parametrize("executor", ["cuda", "auto"])
def test_executive_fleet_equals_batched(executor, cuda):
    """The Executive round on the kernel (a budget of the quantum, the
    hand-back, ``preempted`` read before the preempt), and under "auto" on
    the checks-elided instance, byte-identical to the batched Executive
    fleet on the card, with equal counters."""
    cfg = CFGS[0]
    declined = executor == "cuda"
    out = {}
    for ex_kind in (executor, "batched"):
        fleet, svcs = _executive_fleet(ex_kind, cfg, cuda, declined)
        launches, elided = kmod.vmloop_call.launches, kmod.vmloop_call.elide_launches
        res = fleet.run(max_rounds=60)
        assert res.statuses == ["done"] * fleet.n
        ran = (kmod.vmloop_call.launches - launches, kmod.vmloop_call.elide_launches - elided)
        out[ex_kind] = (res, vms.stack_states([vm.state for vm in fleet.nodes]), fleet, svcs, ran)
    (rk, Sk, fk, sk, ran), (rb, Sb, fb, sb, _) = out[executor], out["batched"]
    assert rk.rounds == rb.rounds and rk.outputs == rb.outputs
    assert check.max_abs_diff(Sk, Sb) == (0, [])
    assert [vm.out_stream for vm in fk.nodes] == [vm.out_stream for vm in fb.nodes]
    assert sk.uart.stream == sb.uart.stream and len(sk.uart.stream) == (fk.n if declined else 0)
    ek, eb = fk.executive_stats(), fb.executive_stats()
    ek.pop("executor"), eb.pop("executor")
    assert ek == eb and ek["preemptions"] > 0 and ek["task_switches"] > 0
    assert ran[0] >= ek["exec_slices"] > 0
    ks = fk.kernel_stats()
    assert ks["exec_slices"] == ek["exec_slices"]
    assert ks["kernel_steps"] + ks["fallback_steps"] == ks["total_steps"]
    if declined:
        assert ks["bail_hist"].get("task", 0) > 0 and ran[1] == 0
    else:
        a = fk.analysis_stats()
        assert (a["executor"], a["elide_checks"]) == ("cuda", True)
        assert ran[0] == ran[1] and ks["bail_hist"] == {}


TRACE_PROGS = [
    ": w 0 begin 1+ dup 300 >= until drop ; w 0 v get 10 < if 1 else 2 endif . halt",
    "0 20 0 do 5 rnd + 1+ loop . halt",
    ": t 3 . end ; 0 0 $ t task drop 7 rnd . halt",
]


def test_trace_fleet_equals_cuda(cuda):
    """The trace-JIT on the card: program groups of several nodes (data
    divergence inside one group), declined words as specialized steps, the
    vmloop kernel as the tail at per-node budgets (its launch counter grows,
    the plain version is never taken); byte-identical to executor="cuda"."""
    cfg = CFGS[0]
    n = 12
    out = {}
    for executor in ("trace", "cuda"):
        fleet = FleetVM(cfg, n=n, executor=executor, device=cuda)
        for i, node in enumerate(fleet.nodes):
            node.dios_add("v", [7 * i])
            node.launch(node.load(TRACE_PROGS[i % len(TRACE_PROGS)]))
        launches = kmod.vmloop_call.launches
        res = fleet.run(max_rounds=80)
        assert res.statuses == ["halt"] * n
        out[executor] = (res, vms.stack_states([vm.state for vm in fleet.nodes]), fleet,
                         kmod.vmloop_call.launches - launches)
    (rt, St, ft, lt), (rc, Sc, _, lc) = out["trace"], out["cuda"]
    assert rt.rounds == rc.rounds and rt.outputs == rc.outputs
    assert check.max_abs_diff(St, Sc) == (0, [])
    ts = ft.trace_stats()
    assert lt >= rt.rounds and lc > 0
    assert ts["spec_steps"] > 0 and ts["guard_exits"] > 0 and len(ts["groups"]) >= len(TRACE_PROGS)
    assert ft.kernel_stats()["kernel_steps"] == 0


@pytest.mark.parametrize("backend", ["cuda", "trace"])
def test_single_node_backends_equal_oracle(backend, cuda):
    """REXAVM(backend="cuda"|"trace") on the card over the reference's
    host-IO programs: an `out` mid-slice, a FIOS call, a spawned task with
    sleep/await; byte-identical to the Oracle, with the kernel's counters."""
    from repro_torch.core.vm import REXAVM

    cfg = CFGS[0]
    progs = [("0 30 0 do 1+ loop out halt", False), ("seven 1+ halt", True),
             ("var flag : w 1 flag ! end ; 0 0 $ w task drop 100 1 flag await . flag @ . halt",
              False)]
    for prog, fios in progs:
        vms_ = {}
        for b in (backend, "oracle"):
            vm = REXAVM(cfg, backend=b, device=cuda)
            if fios:
                vm.svc_add("seven", lambda: 7, args=0, ret=1)
            launches = kmod.vmloop_call.launches
            res = vm.run(vm.load(prog), max_slices=100)
            vms_[b] = (vm, res, kmod.vmloop_call.launches - launches)
        (vb, rb, lb), (vo, ro, _) = vms_[backend], vms_["oracle"]
        assert (rb.status, rb.output, rb.steps) == (ro.status, ro.output, ro.steps), prog
        assert vb.out_stream == vo.out_stream
        assert check.max_abs_diff(vms.stack1(vb.state), vms.stack1(vo.state)) == (0, [])
        assert lb >= rb.slices
        ex = vb.executor
        assert ex.h2d == ex.d2h == rb.slices
        if backend == "cuda":
            assert ex.kernel_steps > 0 and ex.kernel_steps + ex.fallback_steps == rb.steps
            if fios:
                assert ex.bailouts >= 1 and ex.bail_hist.get("fios/trap", 0) >= 1
            if "task" in prog:
                assert ex.bail_hist.get("task", 0) >= 1


@pytest.mark.parametrize("M,K,N", [(8, 2560, 640), (1, 6912, 2560), (64, 2560, 6912),
                                   (3, 100, 37), (65, 257, 129)])
def test_fixmatmul_bitwise_equals_plain_version(M, K, N, cuda):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    xq = torch.randint(-128, 128, (M, K), generator=g, device=cuda).to(torch.int8)
    wq = torch.randint(-128, 128, (K, N), generator=g, device=cuda).to(torch.int8)
    sx = torch.rand(M, generator=g, device=cuda) * 0.1
    sw = torch.rand(N, generator=g, device=cuda) * 0.1
    launches = fmod.fixmatmul.launches
    out = fmod.fixmatmul(xq, wq, sx, sw)
    torch.cuda.synchronize()
    assert fmod.fixmatmul.launches == launches + 1
    assert torch.equal(out, fixmatmul_ref(xq, wq, sx, sw))


def _fix_operands(M, K, N, dev, seed, offset=0, code=None):
    """Random int8 codes (or all ``code``) and scales; ``offset`` bytes into
    a larger buffer, so a non-zero one misaligns xq and wq."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ops = []
    for n in (M * K, K * N):
        buf = (torch.full((n + offset,), code, dtype=torch.int8, device=dev) if code is not None
               else torch.randint(-128, 128, (n + offset,), generator=g, device=dev).to(torch.int8))
        ops.append(buf[offset:])
    xq, wq = ops[0].view(M, K), ops[1].view(K, N)
    sx = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
    sw = torch.rand(N, generator=g, device=dev) * 0.05 + 1e-3
    return xq, wq, sx, sw


def _fix_vs_plain(ops):
    launches = fmod.fixmatmul.launches
    out = fmod.fixmatmul(*ops)
    torch.cuda.synchronize()
    assert fmod.fixmatmul.launches == launches + 1
    ref = fixmatmul_ref(*ops)
    assert torch.equal(out, ref), float((out - ref).abs().max())


# danube's decode (K, N), rwkv6-7b's lm_head, then ragged N and K.
STREAM_KN = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560), (2560, 32000), (4096, 65536),
             (100, 37), (2560, 641), (6913, 640)]


@pytest.mark.parametrize("K,N", STREAM_KN)
def test_fixmatmul_stream_bitwise_equals_plain_version(K, N, cuda):
    """The streaming kernel at every decode batch, M = 1..16."""
    for M in range(1, fmod.STREAM_MAX_M + 1):
        assert fmod.plan(M, K, N, 132).kernel == "stream"
        _fix_vs_plain(_fix_operands(M, K, N, cuda, seed=M * 131 + K + N))


@pytest.mark.parametrize("M,K,N", [(8, 2560, 640), (16, 6912, 2560), (3, 100, 37), (1, 2560, 32000)])
def test_fixmatmul_stream_misaligned_operands(M, K, N, cuda):
    """xq and wq one byte past a 16-byte boundary take the byte loads."""
    ops = _fix_operands(M, K, N, cuda, seed=K + N, offset=1)
    assert ops[0].data_ptr() % 16 and ops[1].data_ptr() % 16
    _fix_vs_plain(ops)


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("code", [-128, 127])
def test_fixmatmul_stream_extreme_codes(M, code, cuda):
    """All codes at one extreme at K = 6912: the largest sums of decode."""
    _fix_vs_plain(_fix_operands(M, 6912, 640, cuda, seed=0, code=code))


def test_fixmatmul_stream_is_one_launch(cuda):
    """At M <= 16 a call is one kernel on the card (no partial-sum array,
    no second kernel), as torch.profiler sees it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ops = _fix_operands(8, 2560, 640, cuda, seed=1)
    fmod.fixmatmul(*ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fmod.fixmatmul(*ops)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    seen = dict(collections.Counter(names))
    assert len(names) == 3 and all("fixmatmul_stream_kernel" in n for n in names), (
        f"CUDA events torch.profiler saw (name: count): {seen}")


@pytest.mark.parametrize("M,kernel,tile,splits,per", [
    (17, 1, 64, 4, 640),        # the streaming kernel takes M <= 16
    (8, 1, 64, 9, 320),         # at most 8 blocks a cluster
    (8, 1, 32, 4, 640),         # no such column tile
    (8, 1, 64, 5, 624),         # splits are whole 32-deep steps
    (8, 1, 64, 2, 640),         # the splits do not cover K
    (8, 2, 64, 4, 640),         # no such kernel
    (8, 0, 3, 4, 640),          # the tiled kernel has no 3 rows a thread
])
def test_fixmatmul_entry_refuses_what_it_does_not_take(M, kernel, tile, splits, per, cuda):
    K, N = 2560, 640
    xq, wq, sx, sw = _fix_operands(M, K, N, cuda, seed=2)
    out = torch.empty((M, N), device=cuda)
    part = torch.empty((splits, M, N), dtype=torch.int32, device=cuda)
    err = fmod.LIBRARY.load().fixmatmul_launch(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
        part.data_ptr(), M, K, N, kernel, tile, splits, per,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 1                                   # cudaErrorInvalidValue


def _grad_case(name, dev):
    """(kernel, inputs, the index of the float inputs) at a small shape."""
    g = torch.Generator(device=dev).manual_seed(3)
    if name == "fixmatmul":
        xq, wq, sx, sw = _fix_operands(4, 64, 32, dev, seed=3)
        return fmod.fixmatmul, (xq, wq, sx, sw), (2, 3)
    if name == "flash_attention":
        q, k, v = (torch.randn((1, 2, 64, 16), generator=g, device=dev) for _ in range(3))
        return flash_attention, (q, k, v), (0, 1, 2)
    r, k, v = (torch.randn((1, 2, 16, 16), generator=g, device=dev) * 0.5 for _ in range(3))
    logw = -torch.exp(torch.rand((1, 2, 16, 16), generator=g, device=dev) - 4)
    u = torch.randn((2, 16), generator=g, device=dev)
    s0 = torch.zeros((1, 2, 16, 16), device=dev)
    return rmod.rwkv6_scan, (r, k, v, logw, u, s0), (0, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("name", ["fixmatmul", "flash_attention", "rwkv6_scan"])
def test_kernels_refuse_autograd(name, cuda):
    """A kernel has no backward pass: a floating input that requires grad
    raises under grad mode (each of them in turn) instead of a silently
    constant output; under no_grad the kernel runs."""
    fn, args, floats = _grad_case(name, cuda)
    for i in floats:
        leaf = [a.clone().requires_grad_(j == i) if j in floats else a for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match=f"{name}.*no backward"):
            fn(*leaf)
        with torch.no_grad():
            fn(*leaf)
    torch.cuda.synchronize()


FLASH_TOL = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _flash_vs_plain(q, k, v, causal, window, tol):
    """One launch, held against the plain version; bf16 must take the
    tensor-core kernel, f32 the FP32 one."""
    launches, tc = flash_attention.launches, flash_attention.tc_launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1 and out.dtype == q.dtype
    assert flash_attention.tc_launches == tc + (q.dtype == torch.bfloat16)
    assert out.shape == q.shape
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - ref.float()).abs().max()) <= tol
    return out


@pytest.mark.parametrize("dtype,tol", FLASH_TOL)
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (1, 32, 8, 300, 300, 80, True, 64),
    (2, 4, 4, 100, 257, 128, False, None),
    (1, 8, 2, 129, 129, 64, True, None),
    (1, 4, 2, 130, 130, 16, True, None),        # hd 16 (the SMOKE config), Sq ragged
    (1, 8, 2, 200, 200, 72, True, 100),         # hd 72: columns 72..80 zeroed in smem
    (1, 4, 1, 150, 150, 36, True, 70),          # hd 36: the padded copy (to 40)
    (2, 8, 2, 333, 333, 80, True, 200),         # B 2, GQA 4, a window of no multiple of 64
    (1, 8, 2, 100, 333, 80, False, None),       # non-causal ragged Sk
    (1, 16, 16, 520, 520, 128, True, None),     # hd 128, causal, no window: G 1 (qwen2-moe)
    (1, 36, 4, 300, 300, 128, True, None),      # G 9 (starcoder2-7b)
    (1, 48, 1, 257, 257, 128, True, None),      # G 48, MQA (granite-34b)
])
def test_flash_attention_matches_plain_version(B, H, KV, Sq, Sk, hd, causal, window, dtype,
                                               tol, cuda):
    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    _flash_vs_plain(q, k, v, causal, window, tol)


@pytest.mark.parametrize("dtype,tol", FLASH_TOL)
def test_flash_attention_strided_views(dtype, tol, cuda):
    """The BSHD view that ops.attention passes (the output stays a BSHD
    view), and a row stride of 84 values that the bf16 kernel's 16-byte
    copies cannot take (the wrapper copies it)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, H, KV, S, hd = 2, 8, 2, 257, 80
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=cuda).to(dtype).movedim(1, 2)
               for n in (H, KV, KV))
    out = _flash_vs_plain(q, k, v, True, 100, tol)
    assert out.stride() == q.stride()
    wide = torch.randn((B, H, S, 84), generator=g, device=cuda).to(dtype)[..., :hd]
    _flash_vs_plain(wide, k, v, True, None, tol)


@pytest.mark.parametrize("hd,hd_pad,shift", [
    (80, 80, 0), (80, 96, 0), (80, 64, 0), (72, 72, 0), (40, 48, 0), (64, 64, 1),
])
def test_flash_tc_entry_takes_only_the_routed_instance(hd, hd_pad, shift, cuda):
    """The tensor-core C entry launches the instance the wrapper's ``route``
    names, roundup(hd, 16), and refuses (cudaErrorInvalidValue, 1) any
    other, or a pointer that is not 16-byte aligned, rather than reading
    out of bounds."""
    import ctypes

    famod = importlib.import_module("repro_torch.kernels.flashattn.flashattn")
    B, H, S = 1, 2, 64
    buf = torch.zeros(4, B * H * S * hd + 8, dtype=torch.bfloat16, device=cuda)
    q, k, v, out = (buf[i, shift:shift + B * H * S * hd].view(B, H, S, hd) for i in range(4))
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out) for s in t.stride()[:3]])
    err = famod.TC_LIBRARY.load().flash_attention_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, strides, B, H, H, S, S,
        hd, hd_pad, 1, 0, 1.0, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    valid = hd_pad == famod.route(q, k, v).hd_pad and shift == 0
    assert err == (0 if valid else 1)


# The backward kernel (csrc/flashattn_bwd.cu) at the shapes of chip_smoke.py
# phase 9 (a), cut in S where the plain version would take long: danube's
# (32 heads over 8, hd 80, a window, and a window shorter than S),
# qwen2-moe's hd 128 causal, zamba2's HD_PAD 64 causal and whisper's
# non-causal encoder at S 1500, plus ragged S and the small head_dims.
# Tolerance: max |kernel - plain| over max |plain|, 1e-4 in f32 (sums in
# another order) and 1e-2 in bf16 (dq, dk, dv are rounded to bf16: one
# step is 2^-8 of a value).  The forward's output, from the instance that
# writes lse, is held first at the forward's tolerance (FLASH_TOL) over
# max(1, max |plain|).
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLASH_FWD_TOL = dict(FLASH_TOL)


def _fwd_err(out, ref):
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1))


def _flash_bwd_vs_plain(q, k, v, causal, window):
    from repro_torch.kernels.flashattn import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flashattn.ref import flash_attention_bwd_ref, flash_attention_lse_ref

    g = torch.Generator(device=q.device).manual_seed(q.shape[2])
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    out_r, lse_r = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _fwd_err(out, out_r) <= FLASH_FWD_TOL[q.dtype]
    assert float((lse - lse_r).abs().max()) <= 1e-4 * max(1.0, float(lse_r.abs().max()))
    dout = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    n, tc = flash_attention.bwd_launches, flash_attention.bwd_tc_launches
    grads = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == n + BWD_KERNELS
    assert flash_attention.bwd_tc_launches == tc + BWD_TC_KERNELS * (q.dtype == torch.bfloat16)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, a, b, t in zip(("dq", "dk", "dv"), grads, refs, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel <= FLASH_BWD_TOL[q.dtype], (name, rel)
    return grads


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", [
    (1, 32, 8, 4096, 80, True, 4096, torch.bfloat16),       # danube
    (1, 32, 8, 2048, 80, True, 1000, torch.bfloat16),       # a window shorter than S
    (1, 16, 16, 2048, 128, True, None, torch.bfloat16),     # qwen2-moe: hd 128
    (1, 32, 32, 2048, 64, True, None, torch.bfloat16),      # zamba2: HD_PAD 64
    (2, 6, 6, 1500, 64, False, None, torch.bfloat16),       # whisper's encoder
    (1, 8, 2, 333, 80, True, 100, torch.float32),           # f32, ragged S
    (1, 4, 2, 130, 16, True, None, torch.bfloat16),         # hd 16 (SMOKE)
    (1, 4, 1, 150, 36, True, 70, torch.float32),            # hd 36, MQA
    (1, 8, 2, 200, 72, False, None, torch.float32),         # hd 72 non-causal
    (1, 8, 2, 333, 80, True, 40, torch.bfloat16),           # S no multiple of the tiles, window < a tile
])
def test_flash_attention_bwd_matches_plain_version(B, H, KV, S, hd, causal, window, dtype, cuda):
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q, k, v = (torch.randn(sh, generator=g, device=cuda).to(dtype)
               for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    _flash_bwd_vs_plain(q, k, v, causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_strided_views(dtype, cuda):
    """The BSHD views the model passes through ops.attention, and a row
    stride of 84 values; the gradients keep their operand's layout."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, KV, S, hd = 2, 8, 2, 257, 80
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=cuda).to(dtype).movedim(1, 2)
               for n in (H, KV, KV))
    dq, dk, _ = _flash_bwd_vs_plain(q, k, v, True, 100)
    assert dq.stride() == q.stride() and dk.stride() == k.stride()
    wide = torch.randn((B, H, S, 84), generator=g, device=cuda).to(dtype)[..., :hd]
    _flash_bwd_vs_plain(wide, k, v, True, None)


def _bwd_inputs(dtype, dev, B=1, H=8, KV=2, S=300, hd=80, causal=True, window=64):
    from repro_torch.kernels.flashattn import flash_attention_fwd

    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v, dout = (torch.randn(sh, generator=g, device=dev).to(dtype)
                     for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    return (q, k, v, out, lse, dout), dict(causal=causal, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_counts_tensor_core_launches(dtype, cuda):
    """A bf16 backward call launches the tensor-core kernels (dK/dV and
    dQ) and raises ``bwd_tc_launches`` by BWD_TC_KERNELS; an f32 call runs
    the FP32-pipe kernels and leaves it; both raise ``bwd_launches`` by
    BWD_KERNELS."""
    from repro_torch.kernels.flashattn import flash_attention_bwd

    args, mask = _bwd_inputs(dtype, cuda)
    n, tc = flash_attention.bwd_launches, flash_attention.bwd_tc_launches
    flash_attention_bwd(*args, **mask)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == n + BWD_KERNELS
    assert flash_attention.bwd_tc_launches == tc + (BWD_TC_KERNELS if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (1, 32, 8, 1024, 80, True, 512),        # danube's heads, a window
    (2, 6, 6, 300, 64, False, None),        # non-causal
    (1, 16, 16, 260, 128, True, None),      # HD_PAD 128
])
def test_flash_attention_bwd_is_deterministic(B, H, KV, S, hd, causal, window, cuda):
    """Two bf16 backward calls on the same inputs give the same bits in
    dq, dk and dv: no atomics, every sum in a fixed order."""
    from repro_torch.kernels.flashattn import flash_attention_bwd

    args, mask = _bwd_inputs(torch.bfloat16, cuda, B, H, KV, S, hd, causal, window)
    first = flash_attention_bwd(*args, **mask)
    second = flash_attention_bwd(*args, **mask)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_matches_plain_autograd(dtype, cuda):
    """``ops.attention`` with inputs that require grad takes FlashAttention
    (one forward launch and one backward call of three kernels) and gives
    the output and the gradients that autograd takes through the plain
    version, at the tolerances of the forward and the backward kernel's
    test."""
    from repro_torch.kernels.flashattn.ops import attention
    from repro_torch.models.attention import blocked_attention

    g = torch.Generator(device=cuda).manual_seed(11)
    B, S, H, KV, hd = 2, 300, 8, 2, 80
    base = [torch.randn((B, S, n, hd), generator=g, device=cuda).to(dtype) for n in (H, KV, KV)]
    dout = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
    grads, outs = {}, {}
    for name, fn in (("kernel", attention), ("plain", blocked_attention)):
        leaves = [t.clone().requires_grad_(True) for t in base]
        n, nb = flash_attention.launches, flash_attention.bwd_launches
        out = fn(*leaves, causal=True, window=64)
        out.backward(dout)
        torch.cuda.synchronize()
        if name == "kernel":
            assert (flash_attention.launches, flash_attention.bwd_launches) == \
                (n + 1, nb + BWD_KERNELS)
        grads[name], outs[name] = [t.grad for t in leaves], out.detach()
    assert outs["kernel"].dtype == dtype and outs["kernel"].shape == outs["plain"].shape
    assert _fwd_err(outs["kernel"], outs["plain"]) <= FLASH_FWD_TOL[dtype]
    for a, b in zip(grads["kernel"], grads["plain"]):
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel <= 2 * FLASH_BWD_TOL[dtype], rel


def test_bench_cuda_events_times_the_card(cuda):
    """``bench(..., cuda_events=True)`` times a spin kernel of a few ms on
    the card: more than 1 ms, and no more than the host clock's time of
    the same calls (which also holds the launch and the synchronization)."""
    from repro_torch.utils.timing import bench

    host = bench(torch.cuda._sleep, 10_000_000, iters=3)
    card = bench(torch.cuda._sleep, 10_000_000, iters=3, cuda_events=True)
    assert 1e-3 < card <= 1.1 * host


def test_other_kernels_still_refuse_grad(cuda, monkeypatch):
    """rwkv6 trains through rwkv6_scan's backward kernel: one SGD step of
    the rwkv6 SMOKE model (f32, remat) at B 2, S 128 (two chunks) on the
    card launches the forward twice a layer and the backward kernels once
    a layer, never the plain scan, and matches the same step on the CPU
    (the plain path): loss, CE and grad_norm within 1e-4 relative, every
    updated param within 1e-5 of its largest value (f32 sums in another
    order; SGD's update is linear in the gradient).  The raw kernels keep
    refusing (test_kernels_refuse_autograd: fixmatmul, flash_attention,
    rwkv6_scan), and lut_sigmoid takes only int32, which cannot require
    grad (a float input raises)."""
    from repro_torch.config import TrainConfig, get_smoke
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_flatten_with_names, tree_map

    cfg = get_smoke("rwkv6-7b")
    tcfg = TrainConfig(lr=0.2, warmup_steps=1, total_steps=4, optimizer="sgd")
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    cpu_state = init_train_state(cpu_model, tcfg, 0)
    copy = lambda t: t.detach().clone().to(cuda).requires_grad_(t.requires_grad)
    gpu_state = cpu_state._replace(params=tree_map(copy, cpu_state.params),
                                   opt=tree_map(copy, cpu_state.opt))
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def plain(*args, **kwargs):
        raise AssertionError("the plain scan ran on the card")

    with monkeypatch.context() as m:
        for name in ("rwkv6_scan_ref", "chunk_states_ref", "chunk_outputs_ref", "chunk_dstates_ref",
                     "chunk_grads_ref"):
            m.setattr(rmod, name, plain)
        n, nb = rmod.rwkv6_scan.launches, rmod.rwkv6_scan.bwd_launches
        new_gpu, m_gpu = make_train_step(gpu_model, tcfg)(
            gpu_state, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert rmod.rwkv6_scan.launches - n == 2 * cfg.num_layers
        assert rmod.rwkv6_scan.bwd_launches - nb == rmod.BWD_KERNELS * cfg.num_layers
    new_cpu, m_cpu = make_train_step(cpu_model, tcfg)(cpu_state, batch)
    for key in ("loss", "ce", "grad_norm"):
        assert float(m_gpu[key]) == pytest.approx(float(m_cpu[key]), rel=1e-4), key
    want = dict(tree_flatten_with_names(new_cpu.params))
    for name, leaf in tree_flatten_with_names(new_gpu.params):
        b = want[name]
        assert float((leaf.detach().cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    with pytest.raises(ValueError, match="int32"):
        lmod.lut_sigmoid(torch.zeros(8, device=cuda, requires_grad=True))


RWKV_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,K,chunk,decay", [
    (1, 4, 256, 64, 64, "slow"),        # four chunks at the model's head size
    (2, 3, 128, 16, 32, "slow"),        # L 32, the SMOKE head size
    (2, 2, 64, 64, 64, "slow"),         # one chunk: the one-block route's state
    (1, 8, 256, 64, 64, "fast"),        # the clip at -60 active
    (2, 4, 96, 36, 32, "slow"),         # K 36
    (1, 64, 512, 64, 64, "slow"),       # the model's heads
])
def test_rwkv6_scan_bwd_matches_plain_version(B, H, S, K, chunk, decay, dtype, cuda):
    """``RwkvScan`` (the forward kernel keeping its chunk states, then the
    backward kernels) against autograd of the plain version from the same
    inputs, a state in and a gradient of the last state: every gradient
    within 1e-4 (f32) or 1e-2 (bf16) of the plain version's largest value;
    one backward call is ``BWD_KERNELS`` launches."""
    r, k, v, logw, u, s0 = _rwkv_inputs(B, H, S, K, dtype, cuda, S + K + B, decay)
    g = torch.Generator(device=cuda).manual_seed(S)
    dout = torch.randn((B, H, S, K), generator=g, device=cuda).to(dtype)
    ds1 = torch.randn((B, H, K, K), generator=g, device=cuda)
    grads = {}
    for name in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
        n = rmod.rwkv6_scan.bwd_launches
        if name == "kernel":
            out, s1 = rmod.RwkvScan.apply(*leaves, chunk)
        else:
            out, s1 = rwkv6_scan_ref(*leaves, chunk=chunk)
        grads[name] = torch.autograd.grad((out.float() * dout.float()).sum() + (s1 * ds1).sum(),
                                          leaves)
        torch.cuda.synchronize()
        assert rmod.rwkv6_scan.bwd_launches - n == (rmod.BWD_KERNELS if name == "kernel" else 0)
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel <= RWKV_BWD_TOL[dtype], rel


def test_rwkv6_scan_bwd_is_deterministic(cuda):
    """Two backward calls from the same inputs give the same bits (no
    atomics; du's per-(batch, chunk) shares are summed in a fixed order)."""
    r, k, v, logw, u, s0 = _rwkv_inputs(2, 8, 512, 64, torch.bfloat16, cuda, 11)
    dout = torch.randn((2, 8, 512, 64), device=cuda).to(torch.bfloat16)
    ds1 = torch.randn((2, 8, 64, 64), device=cuda)
    _, _, states = rmod._launch(r, k, v, logw, u, s0, 64, keep_states=True)
    a, b = (rmod.rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wkv_under_autograd_refuses_state_out(cuda):
    """The decode path's in-place state write cannot be followed by
    autograd: ``ops.wkv`` refuses ``state_out`` when an input requires
    grad, and takes it under no_grad."""
    from repro_torch.kernels.rwkv6_scan.ops import wkv

    r, k, v, logw, u, s0 = _rwkv_inputs(1, 4, 64, 16, torch.float32, cuda, 5)
    flat = lambda x: x.movedim(1, 2).reshape(1, 64, 64)
    args = (flat(r).requires_grad_(True), flat(k), flat(v), flat(logw), u.reshape(-1), s0, 16)
    with pytest.raises(ValueError, match="state_out"):
        wkv(*args, state_out=s0)
    with torch.no_grad():
        wkv(*args, state_out=s0)


def test_moe_int8_kv_decode_matches_cpu(cuda):
    """qwen2-moe SMOKE with int8 weights on the int8 KV cache: four decode
    steps on the card (fixmatmul for the projections) against the CPU.
    Last-bit differences of f32 sums can move an activation's int8 code or
    a bf16-rounded value by one step; 2e-2 bounds what that does to a logit
    (chip_smoke.py's SMOKE_TOL)."""
    from repro_torch.config import get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.quantized import quantize_params
    from repro_torch.utils.tree import tree_map_with_names

    cfg = get_smoke("qwen2-moe-a2.7b").replace(kv_cache_dtype="int8")
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = quantize_params(cpu_model.init(0))
    p_gpu = tree_map_with_names(lambda _, x: x.to(cuda), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (3, 4), generator=torch.Generator().manual_seed(0))
    c_cpu, c_gpu = cpu_model.init_cache(3, 8), gpu_model.init_cache(3, 8)
    before = fmod.fixmatmul.launches
    for t in range(toks.shape[1]):
        l_cpu, c_cpu = cpu_model.decode_step(p_cpu, c_cpu, toks[:, t:t + 1])
        l_gpu, c_gpu = gpu_model.decode_step(p_gpu, c_gpu, toks[:, t:t + 1].to(cuda))
        assert float((l_gpu.cpu() - l_cpu).abs().max()) <= 2e-2
    assert fmod.fixmatmul.launches - before == 4 * (4 * cfg.num_layers + 1)
    assert c_gpu.k.dtype == torch.int8 and c_gpu.pos == 4


# The hybrid, encdec and vlm families: flash's HD_PAD 64 instance at
# zamba2's shared block (32/32 heads, cut to S 2048 here; chip_smoke.py
# runs S 8192) and whisper's encoder (B 8, 1500 frames, non-causal: a
# ragged Sk) and decoder (448 tokens, causal).
@pytest.mark.parametrize("dtype,tol", FLASH_TOL)
@pytest.mark.parametrize("B,H,Sq,Sk,causal", [(1, 32, 2048, 2048, True),
                                              (8, 6, 1500, 1500, False),
                                              (8, 6, 448, 448, True)],
                         ids=["zamba2", "whisper_encoder", "whisper_decoder"])
def test_flash_attention_new_family_shapes(B, H, Sq, Sk, causal, dtype, tol, cuda):
    g = torch.Generator(device=cuda).manual_seed(Sq + H)
    q, k, v = (torch.randn((B, Sq, H, 64), generator=g, device=cuda).to(dtype).movedim(1, 2)
               for _ in range(3))
    famod = importlib.import_module("repro_torch.kernels.flashattn.flashattn")
    assert dtype == torch.float32 or famod.route(q, k, v).hd_pad == 64
    _flash_vs_plain(q, k, v, causal, None, tol)


# (K, N) of every quantized projection the three families' decode steps run
FAMILY_KN = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 32000),       # zamba2
             (384, 384), (384, 1536), (1536, 384), (384, 51872),            # whisper
             (2048, 1024), (2048, 92560)]                                   # internvl2


@pytest.mark.parametrize("K,N", FAMILY_KN)
def test_fixmatmul_family_decode_shapes(K, N, cuda):
    """Bitwise at M 8, the decode batch of chip_smoke.py's phase 7i."""
    _fix_vs_plain(_fix_operands(8, K, N, cuda, seed=K + N))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-tiny", "internvl2-2b"])
def test_family_quantized_decode_matches_cpu(arch, cuda):
    """The SMOKE config with int8 weights: six decode steps on the card
    against the CPU, within test_moe_int8_kv_decode_matches_cpu's 2e-2;
    one fixmatmul launch a quantized leaf a step reaches."""
    from repro_torch.config import get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.quantized import quantize_params
    from repro_torch.utils.tree import tree_map_with_names

    cfg = get_smoke(arch)
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = quantize_params(cpu_model.init(0))
    p_gpu = tree_map_with_names(lambda _, x: x.to(cuda), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (3, 6), generator=torch.Generator().manual_seed(0))
    c_cpu, c_gpu = cpu_model.init_cache(3, 8), gpu_model.init_cache(3, 8)
    before = fmod.fixmatmul.launches
    for t in range(toks.shape[1]):
        l_cpu, c_cpu = cpu_model.decode_step(p_cpu, c_cpu, toks[:, t:t + 1])
        l_gpu, c_gpu = gpu_model.decode_step(p_gpu, c_gpu, toks[:, t:t + 1].to(cuda))
        assert float((l_gpu.cpu() - l_cpu).abs().max()) <= 2e-2
    per_step = {"zamba2-1.2b": 7 * 2 + 1, "whisper-tiny": 8 * 2 + 1, "internvl2-2b": 7 * 2 + 1}
    assert fmod.fixmatmul.launches - before == 6 * per_step[arch]


RWKV_TOL = [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)]


def _rwkv_inputs(B, H, S, K, dtype, dev, seed, decay="slow"):
    """``decay="fast"`` draws log decays down to -7.4 a step, so a chunk's
    cumulative decays pass the clip at -60."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = ((torch.randn((B, H, S, K), generator=g, device=dev) * 0.5).to(dtype)
               for _ in range(3))
    lo, hi = (-6.0, -4.0) if decay == "slow" else (-1.0, 2.0)
    logw = -torch.exp(torch.rand((B, H, S, K), generator=g, device=dev) * (hi - lo) + lo)
    u = torch.randn((H, K), generator=g, device=dev) * 0.5
    s0 = torch.randn((B, H, K, K), generator=g, device=dev) * 0.1
    return r, k, v, logw, u, s0


def _rwkv_close(out, s1, ref, ref_s1, out_tol):
    """Tolerances relative to the largest value of ``ref``; bf16 ``out``
    is rounded once, so it may differ by one bf16 step."""
    assert float((out.float() - ref.float()).abs().max()) <= out_tol * max(
        1.0, float(ref.float().abs().max()))
    assert float((s1 - ref_s1).abs().max()) <= 1e-4 * max(1.0, float(ref_s1.abs().max()))


@pytest.mark.parametrize("dtype,out_tol", RWKV_TOL)
@pytest.mark.parametrize("B,H,S,K,chunk,decay", [
    (1, 4, 256, 64, 64, "slow"), (2, 3, 128, 16, 32, "slow"), (8, 8, 1, 64, 64, "slow"),
    (1, 2, 40, 16, 64, "slow"), (2, 2, 48, 64, 16, "slow"), (1, 2, 8, 16, 1, "slow"),
    (1, 64, 1024, 64, 64, "slow"),      # the prefill's heads, 16 chunks
    (2, 3, 512, 64, 64, "slow"),        # a ragged head count
    (2, 4, 256, 16, 16, "slow"),        # the SMOKE head size
    (1, 8, 256, 64, 64, "fast"),        # the clip at -60 active
    (2, 4, 96, 36, 32, "slow"),         # K 36: no 16-byte rows, plain loads
])
def test_rwkv6_scan_matches_plain_version(B, H, S, K, chunk, decay, dtype, out_tol, cuda):
    """Each call takes the kernel ``route`` picks (the two passes when it
    holds two or more chunks, ``chunked_launches`` counting them; the
    decode kernel at one step, ``decode_launches`` counting it), and
    ``state_out=state0`` in place gives the fresh result bit for bit."""
    r, k, v, logw, u, s0 = _rwkv_inputs(B, H, S, K, dtype, cuda, B * S + K, decay)
    launches, chunked = rmod.rwkv6_scan.launches, rmod.rwkv6_scan.chunked_launches
    decode = rmod.rwkv6_scan.decode_launches
    out, s1 = rmod.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert rmod.rwkv6_scan.launches == launches + 1 and out.dtype == dtype
    two_pass = S >= 2 * min(chunk, S)
    assert rmod.route(S, chunk) == ("chunked" if two_pass else "decode" if S == 1 else "one_block")
    assert rmod.rwkv6_scan.chunked_launches == chunked + two_pass
    assert rmod.rwkv6_scan.decode_launches == decode + (S == 1)
    ref, ref_s1 = rwkv6_scan_ref(r, k, v, logw, u, s0, chunk=chunk)
    _rwkv_close(out, s1, ref, ref_s1, out_tol)
    s_in = s0.clone()
    out2, s2 = rmod.rwkv6_scan(r, k, v, logw, u, s_in, chunk=chunk, state_out=s_in)
    torch.cuda.synchronize()
    assert s2 is s_in and torch.equal(out2, out) and torch.equal(s_in, s1)


@pytest.mark.parametrize("dtype,out_tol", RWKV_TOL)
@pytest.mark.parametrize("B,H,S,K,chunk,decay,view", [
    (1, 64, 1024, 64, 64, "slow", "bshk"),    # the model's (B, S, D) layout, viewed
    (1, 8, 512, 64, 64, "fast", "dense"),
    (2, 4, 256, 16, 16, "slow", "dense"),
    (1, 4, 128, 64, 64, "slow", "shifted"),   # operands one element off 16 bytes
    (2, 4, 96, 36, 32, "slow", "dense"),
])
def test_rwkv6_scan_two_passes_match_one_block(B, H, S, K, chunk, decay, view, dtype, out_tol,
                                               cuda):
    """The two passes against the one-block kernel on the same operands:
    the same outputs and state within the plain version's tolerances."""
    r, k, v, logw, u, s0 = _rwkv_inputs(B, H, S, K, dtype, cuda, S + K, decay)
    if view == "bshk":
        r, k, v, logw = (t.movedim(1, 2).contiguous().movedim(2, 1) for t in (r, k, v, logw))
    elif view == "shifted":
        r, k, v, logw = (_shifted(t) for t in (r, k, v, logw))
    chunked = rmod.rwkv6_scan.chunked_launches
    out, s1 = rmod.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk, kernel="chunked")
    one, one_s1 = rmod.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk, kernel="one_block")
    torch.cuda.synchronize()
    assert rmod.rwkv6_scan.chunked_launches == chunked + 1
    _rwkv_close(out, s1, one, one_s1, out_tol)


def test_rwkv6_scan_route_sends_one_chunk_to_one_block(cuda):
    """S / L = 1 takes the decode kernel at one step (the decode step) and
    the one-block kernel at 1 < S <= chunk (a prompt shorter than a
    chunk); two chunks or more take the two passes."""
    for S, chunk in ((1, 64), (40, 64), (64, 64), (16, 16), (1, 1)):
        assert rmod.route(S, chunk) == ("decode" if S == 1 else "one_block")
        r, k, v, logw, u, s0 = _rwkv_inputs(2, 4, S, 16, torch.float32, cuda, S)
        chunked, decode = rmod.rwkv6_scan.chunked_launches, rmod.rwkv6_scan.decode_launches
        rmod.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
        assert rmod.rwkv6_scan.chunked_launches == chunked
        assert rmod.rwkv6_scan.decode_launches == decode + (S == 1)
    for S, chunk in ((128, 64), (32, 16), (2, 1)):
        assert rmod.route(S, chunk) == "chunked"
    r, k, v, logw, u, s0 = _rwkv_inputs(2, 4, 16, 16, torch.float32, cuda, 3)
    with pytest.raises(ValueError, match="one step"):
        rmod.rwkv6_scan(r, k, v, logw, u, s0, kernel="decode")
    torch.cuda.synchronize()


def _shifted(t):
    """``t`` copied into a buffer one element past its start: contiguous,
    no longer 16-byte aligned."""
    buf = t.new_empty(t.numel() + 1)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,out_tol", RWKV_TOL)
@pytest.mark.parametrize("B,H,K,decay,view", [
    (8, 64, 64, "slow", "dense"),       # the rwkv6-7b decode step
    (1, 64, 64, "slow", "dense"),
    (8, 3, 64, "slow", "dense"),        # a ragged head count
    (1, 3, 36, "slow", "dense"),        # K 36: a ragged last tile
    (8, 64, 16, "slow", "dense"),       # the SMOKE head size
    (8, 64, 64, "fast", "dense"),       # decays down to -7.4
    (2, 3, 36, "fast", "dense"),
    (8, 64, 64, "slow", "bshk"),        # the model's (B, S, D) layout, viewed
    (1, 3, 16, "slow", "bshk"),
    (8, 3, 64, "slow", "shifted"),      # operands and state one element off 16 bytes
    (1, 64, 36, "slow", "shifted"),
    (2, 3, 30, "slow", "dense"),        # K no multiple of 4: scalar state rows
])
def test_rwkv6_scan_decode_matches_plain_version(B, H, K, decay, view, dtype, out_tol, cuda):
    """One step takes the decode kernel; it agrees with the plain version,
    with its closed form ``decode_ref`` and with the one-block kernel on
    the same operands, and in place gives the fresh result bit for bit."""
    r, k, v, logw, u, s0 = _rwkv_inputs(B, H, 1, K, dtype, cuda, 7 * B + H + K, decay)
    if view == "bshk":
        r, k, v, logw = (t.movedim(1, 2).contiguous().movedim(2, 1) for t in (r, k, v, logw))
    elif view == "shifted":
        r, k, v, logw, u, s0 = (_shifted(t) for t in (r, k, v, logw, u, s0))
    launches, decode = rmod.rwkv6_scan.launches, rmod.rwkv6_scan.decode_launches
    out, s1 = rmod.rwkv6_scan(r, k, v, logw, u, s0)
    one, one_s1 = rmod.rwkv6_scan(r, k, v, logw, u, s0, kernel="one_block")
    torch.cuda.synchronize()
    assert (rmod.rwkv6_scan.launches, rmod.rwkv6_scan.decode_launches) == (launches + 2, decode + 1)
    assert out.dtype == dtype and out.shape == (B, H, 1, K)
    for want, want_s1 in (rwkv6_scan_ref(r, k, v, logw, u, s0), decode_ref(r, k, v, logw, u, s0),
                          (one, one_s1)):
        _rwkv_close(out, s1, want, want_s1, out_tol)
    s_in = s0.clone()
    out2, s2 = rmod.rwkv6_scan(r, k, v, logw, u, s_in, state_out=s_in)
    torch.cuda.synchronize()
    assert s2 is s_in and torch.equal(out2, out) and torch.equal(s_in, s1)


@pytest.mark.parametrize("dtype,out_tol", RWKV_TOL)
def test_rwkv6_scan_decode_in_place_chain(dtype, out_tol, cuda):
    """Four decode steps in place on one state, back to back on one stream
    (each launch reads the state the one before it writes), against four
    plain steps."""
    steps = [_rwkv_inputs(8, 64, 1, 64, dtype, cuda, 40 + i) for i in range(4)]
    u, state = steps[0][4], steps[0][5]
    ref_state = state.clone()
    decode = rmod.rwkv6_scan.decode_launches
    outs = [rmod.rwkv6_scan(r, k, v, logw, u, state, state_out=state)[0]
            for r, k, v, logw, _, _ in steps]
    torch.cuda.synchronize()
    assert rmod.rwkv6_scan.decode_launches == decode + 4
    for out, (r, k, v, logw, _, _) in zip(outs, steps):
        ref, ref_state = rwkv6_scan_ref(r, k, v, logw, u, ref_state)
        assert float((out.float() - ref).abs().max()) <= out_tol * max(1.0, float(ref.abs().max()))
    _rwkv_close(outs[-1], state, ref, ref_state, out_tol)


def test_lut_sigmoid_bitwise_equals_plain_version(cuda):
    i32 = torch.iinfo(torch.int32)
    edges = [i32.min, i32.min + 1, i32.max, 0, 1, -1] + [s * x for s in (1, -1)
                                                         for x in (7999, 8000, 8001)]
    edges += [m + d for m in range(-8250, 8251, 250) for d in (-1, 0, 1)]
    g = torch.Generator(device=cuda).manual_seed(0)
    rnd = torch.randint(i32.min, i32.max, (1 << 20,), generator=g, device=cuda, dtype=torch.int32)
    x = torch.cat([torch.tensor(edges, dtype=torch.int32, device=cuda), rnd])
    for shaped in (x, x[1:], x[:3 * 7 * 1000].reshape(3, 7, 1000)):
        launches = lmod.lut_sigmoid.launches
        out = lmod.lut_sigmoid(shaped)
        torch.cuda.synchronize()
        assert lmod.lut_sigmoid.launches == launches + 1 and out.shape == shaped.shape
        assert torch.equal(out, lut_sigmoid_ref(shaped))
