"""Drive the PyTorch port on one NVIDIA GPU: the REXAVM fleet, and
h2o-danube-1.8b served with the VM fleet as its measuring job.

    python3 chip_smoke.py [--nodes N]

Run from the root of a checkout on a machine with CUDA and nvcc.  Phases,
each printing its results on a line of its own:

  1. the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels (vmloop, fixmatmul, flash attention) from
     the sources in the checkout, one nvcc each, all started together, and
     print each one's ptxas register and spill lines;
  3. hold vmloop against its plain PyTorch version on the card: the
     per-opcode sweep and a batch of random node states, byte for byte on
     every field and on n_exec/bailed/bail_op; every claimed word must run
     in the kernel, task/rnd/FIOS must bail;
  4. the fleet's main path: FleetVM(VMConfig(), n=4096, executor="cuda"),
     every node running a small fixed-point ANN (vecfold + dotprod +
     sigmoid), then sending its result round a ring; every 16th node also
     draws `rnd` and spawns a task, so the interpreter tail runs on the
     card.  Run with service_every=1 and 8, each held byte for byte against
     executor="batched" on the card; every node must halt;
  5. vmloop's time per launch, its plain version's time, and its bound;
  6. fixmatmul bitwise against its plain version at danube's decode shapes
     (M = 1, 8, 64), ragged shapes and extreme codes; flash attention
     against its plain version in bf16 and f32 over causal / non-causal,
     windows, GQA, Sq != Sk, ragged lengths and head_dim 64/80/128;
  7. the serve path at full width: h2o-danube-1.8b (24 layers, bf16,
     weights drawn on the card from a seed).  (a) prefill: Model.forward at
     B = 1, S = 8192 through the flash kernel (24 launches), held against
     the same forward with the plain attention; (b) quantize_params, then
     ServeEngine with FleetServeMonitor(n=64, executor="cuda") as on_step,
     64 greedy tokens for 8 prompts of 128 seeded tokens: 169 fixmatmul
     launches per decode step, vmloop launched by the monitor, every node
     reporting [8] * 64; (c) a small-input reference: the SMOKE config's
     quantized engine on the card gives the CPU's tokens; (d) where a
     decode step's device time goes (torch.profiler);
  8. each new kernel's time per launch at the main path's shapes, its plain
     version's, one PyTorch library call's, and its bound.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 33.5e12       # H100 SXM non-tensor INT32 rate (data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core rate (data sheet)
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate (data sheet)
N_NODES = 4096
ITERS = 20                      # ANN iterations per node
ARCH = "h2o-danube-1.8b"
PREFILL_LEN = 8192              # crosses danube's 4096 window
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS, MONITOR_NODES = 8, 128, 64, 64
SEED = 0
L2_BYTES = 50e6                 # H100 L2; timed weights are rotated past it
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max abs err vs the plain version
PREFILL_REL_TOL = 5e-2          # max |logit diff| / max |logit|, bf16 over 24 layers
SPIN_CYCLES = 100_000_000       # ~50 ms of spinning at the H100's clock
SMOKE_TOL = 2e-2                # max |logit diff|, card vs CPU, SMOKE quantized decode


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ann_program(i: int, n: int) -> str:
    extra = ""
    if i % 16 == 0:
        extra = ": worker 5 0 do i acc +! loop ; 0 0 $ worker task drop 100 rnd acc +! "
    return (
        "array x { 10 20 30 40 } "
        "array w { 1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 } "
        "array y { 0 0 0 0 } var acc "
        f"{extra}"
        f"0 begin 1+ x w y 0 vecfold x y dotprod acc +! dup {ITERS} >= until drop "
        f"acc @ 4000 mod 2000 - sigmoid {(i + 1) % n} send "
        "receive swap drop acc ! acc @ . halt"
    )


def differing(A, B, pairs, limit: int = 6) -> list:
    """(word, program, field) of the first nodes where A and B differ."""
    out = []
    for f in A._fields:
        a, b = getattr(A, f), getattr(B, f)
        rows = (a != b).reshape(a.shape[0], -1).any(dim=1).nonzero().flatten().tolist()
        out += [(*pairs[i], f) for i in rows[:limit]]
    return out[:limit]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=N_NODES, help="fleet size of phase 4")
    n_nodes = ap.parse_args().nodes

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import importlib

        from repro_torch.config import VMConfig
        from repro_torch.core.vm import FleetVM, REXAVM, vmstate as vms
        from repro_torch.kernels.nvcc import BuildError
        from repro_torch.kernels.vmloop import check, vmloop as kmod
        from repro_torch.kernels.vmloop.ref import SUPPORTED_WORDS, core_of, vmloop_ref
        fix_mod = importlib.import_module("repro_torch.kernels.fixmatmul.fixmatmul")
        flash_mod = importlib.import_module("repro_torch.kernels.flashattn.flashattn")
    except ImportError as e:
        fail(f"the repository's src/repro_torch is not beside this script ({e})")
    dev = torch.device("cuda")
    # The plain versions' float32 products run in full f32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # 2. build: one nvcc per kernel, all started together
    t0 = time.perf_counter()
    libs = (kmod.LIBRARY, fix_mod.LIBRARY, flash_mod.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:
        for lib, fut in [(lib, pool.submit(lib.build)) for lib in libs]:
            try:
                fut.result()
            except BuildError as e:
                fail(f"{lib.name} did not build: {e}")
    for lib in libs:
        lib.load()
        print(f"build: {lib.name} {lib.seconds:.2f} s nvcc", flush=True)
        print(f"ptxas {lib.name}: " + " | ".join(lib.ptxas_lines()), flush=True)
    print(f"build: all three {time.perf_counter() - t0:.2f} s with loading", flush=True)

    # 3. kernel vs plain version on the card
    max_err = 0
    for cfg in (VMConfig(cs_size=2048, steps_per_slice=64, mbox_size=4), VMConfig()):
        pairs, S = check.sweep_states(cfg, dev)
        P = vms.clone(S)
        _, n_k, b_k, o_k = kmod.vmloop_call(core_of(S), cfg.steps_per_slice, cfg)
        _, n_p, b_p, o_p = vmloop_ref(P, cfg.steps_per_slice, cfg)
        torch.cuda.synchronize()
        err, bad = check.max_abs_diff(S, P)
        for name, a, b in (("n_exec", n_k, n_p), ("bailed", b_k, b_p), ("bail_op", o_k, o_p)):
            if not torch.equal(a, b):
                bad.append(name)
                err = max(err, int((a.long() - b.long()).abs().max()))
        if bad:
            fail(f"sweep (cs_size={cfg.cs_size}): kernel != plain on {bad}, max abs err {err}; "
                 f"programs: {differing(S, P, pairs)}")
        max_err = max(max_err, err)
        n_k, b_k = n_k.cpu().tolist(), b_k.cpu().tolist()
        ran = {w for (w, _), n in zip(pairs, n_k) if n > 0}
        missing = set(SUPPORTED_WORDS) - ran
        if missing:
            fail(f"claimed words the kernel did not execute: {sorted(missing)}")
        for (w, p), b in zip(pairs, b_k):
            if w in ("task", "rnd", "fios/trap") and not b:
                fail(f"kernel did not bail on {w!r} ({p})")
        R = check.random_states(cfg, 1024, seed=cfg.cs_size, device=dev)
        Rp = vms.clone(R)
        _, n_k, b_k, o_k = kmod.vmloop_call(core_of(R), 64, cfg)
        _, n_p, b_p, o_p = vmloop_ref(Rp, 64, cfg)
        torch.cuda.synchronize()
        err, bad = check.max_abs_diff(R, Rp)
        if bad or not (torch.equal(n_k, n_p) and torch.equal(b_k, b_p) and torch.equal(o_k, o_p)):
            fail(f"random states (cs_size={cfg.cs_size}): kernel != plain on {bad}, max abs err {err}")
        print(f"check cs_size={cfg.cs_size}: sweep {len(pairs)} programs, random 1024 nodes "
              f"({int(n_k.sum())} instructions, {int(b_k.sum())} bails): byte-identical", flush=True)

    # 4. the main path: the full-size fleet
    cfg = VMConfig()
    t0 = time.perf_counter()
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(n_nodes)]
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(ann_program(i, n_nodes)))
    init = [vms.clone(vm.state) for vm in nodes]
    state_mb = vms.state_nbytes(init[0]) * n_nodes / 1e6
    print(f"fleet: {n_nodes} nodes, {state_mb:.1f} MB of state, set up in {time.perf_counter() - t0:.1f} s", flush=True)

    def run(executor: str, service_every: int):
        for vm, st in zip(nodes, init):
            vm.state = vms.clone(st)
            vm.out_stream.clear()
        fleet = FleetVM(nodes=nodes, executor=executor, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fleet.run(max_rounds=200, service_every=service_every)
        dt = time.perf_counter() - t
        final = vms.stack_states([vm.state for vm in nodes])
        return fleet, res, dt, final

    kmod.vmloop_call.launches = 0
    results = {}
    for every in (1, 8):
        for executor in ("cuda", "batched"):
            results[executor, every] = run(executor, every)
    launches = kmod.vmloop_call.launches
    for every in (1, 8):
        fc, rc, dtc, Sc = results["cuda", every]
        fb, rb, dtb, Sb = results["batched", every]
        if rc.statuses != ["halt"] * n_nodes:
            fail(f"service_every={every}: not every node halted: "
                 f"{sorted(set(rc.statuses))}")
        err, bad = check.max_abs_diff(Sc, Sb)
        if bad or rc.outputs != rb.outputs or rc.rounds != rb.rounds:
            fail(f"service_every={every}: cuda != batched on {bad} (max abs err {err})")
        steps = int(rc.steps.sum())
        ks = fc.kernel_stats()
        if ks["kernel_steps"] <= 0 or ks["fallback_steps"] <= 0:
            fail(f"service_every={every}: kernel {ks['kernel_steps']} / tail "
                 f"{ks['fallback_steps']} steps: both must run")
        print(json.dumps({
            "phase": "fleet", "service_every": every, "nodes": n_nodes, "rounds": rc.rounds,
            "steps": steps, "steps_per_s": steps / dtc, "rounds_per_s": rc.rounds / dtc,
            "msgs_per_s": n_nodes / dtc, "ms_per_round": 1e3 * dtc / rc.rounds,
            "kernel_steps": ks["kernel_steps"], "tail_steps": ks["fallback_steps"],
            "bail_hist": ks["bail_hist"], "bailed_node_rounds": ks["bailed_node_rounds"],
            "batched_steps_per_s": steps / dtb, "batched_ms_per_round": 1e3 * dtb / rb.rounds,
            "identical_to_batched": True,
        }), flush=True)
    if launches <= 0:
        fail("the fleet's main path launched the vmloop kernel no time")
    print(f"main path: vmloop launched {launches} times over 4 fleet runs "
          f"(2 on executor=cuda)", flush=True)

    # 4b. where a round's time goes: the layers of CudaSliceExecutor and the
    # round, each closed by a synchronize (host clock), on a fresh fleet
    from repro_torch.kernels.vmloop.ops import fleet_vmloop

    for vm, st in zip(nodes, init):
        vm.state = vms.clone(st)
    fleet = FleetVM(nodes=nodes, executor="cuda", device=dev)
    fleet.start()
    S, kern = fleet._S, fleet.kernels
    it = kern.interp
    for rnd in range(3):
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        steps0 = S.steps.clone()
        it.schedule(S)
        mark()
        S, n_exec, bailed, _ = fleet_vmloop(S, cfg.steps_per_slice, cfg)
        mark()
        tail = bailed != 0
        n_tail = int(tail.sum())
        if n_tail:
            it.vmloop(S, cfg.steps_per_slice, active=tail, budget=cfg.steps_per_slice - n_exec)
        mark()
        it.preempt(S)
        kern.post_slice(S, steps0)
        mark()
        ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        print(json.dumps({
            "phase": "breakdown", "round": rnd, "schedule_ms": ms[0], "kernel_ms": ms[1],
            "tail_ms": ms[2], "tail_nodes": n_tail, "tail_steps": int(S.steps.sum() - steps0.sum()
                                                                    - n_exec.sum()),
            "preempt_route_warp_ms": ms[3],
        }), flush=True)

    # 5. time per launch at n=4096, beside the plain version and the bound
    S0 = vms.to_device(vms.stack_states(init), dev)
    from repro_torch.core.vm.interp import interp_for
    interp_for(cfg).schedule(S0)
    work = vms.clone(S0)
    core = core_of(work)
    reps = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for rep in range(reps + 2):                 # two warm-up launches
        for a, b in zip(work, S0):
            a.copy_(b)
        start.record()
        n_exec = kmod.vmloop_call(core, cfg.steps_per_slice, cfg)[1]
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:
            total += start.elapsed_time(end)
    ms = total / reps
    plain = vms.clone(S0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    vmloop_ref(plain, cfg.steps_per_slice, cfg)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err, bad = check.max_abs_diff(work, plain)
    if bad:
        fail(f"timed launch != plain version on {bad}")
    # Bound: the cells this launch changed (each written once) plus each
    # node's loaded code frame (its program and arrays, each read once).
    changed = sum(int((a != b).sum()) for a, b in zip(work, S0))
    frame_cells = sum(sum(f.end - f.start for f in vm.frames.frames.values()) for vm in nodes)
    nbytes = 4 * (changed + frame_cells)
    instrs = int(n_exec.sum())
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * instrs / INT32_OPS_PER_S
    print(f"vmloop timing n={n_nodes}: {ms:.4f} ms/launch, plain {plain_ms:.2f} ms, "
          f"{instrs} instructions, bound {max(t_bytes, t_ops):.6f} ms ({nbytes} B)", flush=True)
    records = [{
        "name": "vmloop", "route": "cuda",
        "source": "src/repro_torch/kernels/vmloop/csrc/vmloop.cu",
        "replaces": "src/repro/kernels/vmloop/vmloop.py:64",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]
    del nodes, init, results, S, S0, work, plain, fleet
    torch.cuda.empty_cache()

    # 6. the new kernels against their plain versions
    fix_err = check_fixmatmul(torch, fix_mod, dev)
    flash_err = check_flash(torch, flash_mod, dev)

    # 7. the serve path at full width
    launches_fix, launches_flash = serve_danube(torch, dev, fix_mod, flash_mod, kmod)

    # 8. time per launch at the main path's shapes
    records.append(dict(time_fixmatmul(torch, fix_mod, dev), launches=launches_fix,
                        max_abs_err=fix_err))
    records.append(dict(time_flash(torch, flash_mod, dev), launches=launches_flash,
                        max_abs_err=flash_err))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phases 6-8: fixmatmul, flash attention and the danube serve path
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean ms per call of ``fn(i)`` over ``reps`` calls after ``warmup``,
    by CUDA events around the whole run.  A spin kernel ahead of the first
    event holds the card while the host queues the calls, so a call whose
    host side is slower than its kernel is timed on the device, not at the
    rate Python can launch it."""
    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(reps):
        fn(warmup + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(torch, fn):
    """(fn(), ms) by the host clock, the device synchronized on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def danube_gemms():
    """(K, N, launches per decode step) of the quantized danube projections:
    per layer wq, wk, wv, wo, w1, w3, w2; then lm_head."""
    from repro_torch.config import get_arch

    c = get_arch(ARCH)
    L, d = c.num_layers, c.d_model
    return [(d, c.q_dim, L), (d, c.kv_dim, 2 * L), (c.q_dim, d, L), (d, c.d_ff, 2 * L),
            (c.d_ff, d, L), (d, c.padded_vocab, 1)]


def fix_operands(torch, M, K, N, dev, g, code=None):
    if code is None:
        xq = torch.randint(-128, 128, (M, K), generator=g, device=dev).to(torch.int8)
        wq = torch.randint(-128, 128, (K, N), generator=g, device=dev).to(torch.int8)
    else:
        xq = torch.full((M, K), code, dtype=torch.int8, device=dev)
        wq = torch.full((K, N), code, dtype=torch.int8, device=dev)
    sx = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
    sw = torch.rand(N, generator=g, device=dev) * 0.05 + 1e-3
    return xq, wq, sx, sw


def check_fixmatmul(torch, fix_mod, dev) -> float:
    from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(M, K, N, None) for M in (1, 8, 64) for K, N, _ in danube_gemms()]
    cases += [(3, 100, 37, None), (65, 257, 129, None), (1, 1, 1, None), (17, 6912, 2560, None),
              (8, 6912, 640, -128), (8, 6912, 640, 127), (64, 6912, 2560, -128)]
    for M, K, N, code in cases:
        ops = fix_operands(torch, M, K, N, dev, g, code)
        out, ref = fix_mod.fixmatmul(*ops), fixmatmul_ref(*ops)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = float((out - ref).abs().max())
            fail(f"fixmatmul (M, K, N) = {(M, K, N)}, codes {code}: kernel != plain version, "
                 f"max abs err {err}")
    print(f"check fixmatmul: {len(cases)} shapes (danube decode at M = 1/8/64, ragged, "
          f"extreme codes at K = 6912): bitwise equal", flush=True)
    return 0.0


def check_flash(torch, flash_mod, dev) -> float:
    """Returns the largest error in bf16, the main path's type."""
    from repro_torch.kernels.flashattn.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = [  # (B, H, KV, Sq, Sk, hd, causal, window)
        (1, 32, 8, 512, 512, 80, True, 4096),
        (1, 32, 8, 700, 700, 80, True, 8),
        (2, 8, 8, 200, 200, 64, True, None),
        (1, 8, 2, 100, 333, 128, False, None),
        (2, 4, 1, 129, 129, 80, False, 8),
        (1, 4, 4, 65, 193, 64, False, 4096),
        (1, 8, 2, 300, 300, 128, True, 100),
    ]
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        tol = FLASH_TOL[str(dt).split(".")[1]]
        errs = []
        for B, H, KV, Sq, Sk, hd, causal, window in cases:
            q, k, v = (torch.randn(sh, generator=g, device=dev).to(dt)
                       for sh in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
            out = flash_mod.flash_attention(q, k, v, causal=causal, window=window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if not (out.dtype == dt and err <= tol):
                fail(f"flash attention {dt} {(B, H, KV, Sq, Sk, hd, causal, window)}: "
                     f"max abs err {err} > {tol}")
            errs.append(err)
        worst[dt] = max(errs)
        print(f"check flash attention {dt}: {len(cases)} shapes, max abs err {max(errs):.3g} "
              f"(tolerance {tol})", flush=True)
    return worst[torch.bfloat16]


class StepClock:
    """The model as the engine sees it, with a synchronized host clock
    around each decode step."""

    def __init__(self, torch, model):
        self._torch, self._model, self.ms = torch, model, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *args):
        self._torch.cuda.synchronize()
        t = time.perf_counter()
        out = self._model.decode_step(*args)
        self._torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t))
        return out


class TimedMonitor:
    def __init__(self, torch, monitor):
        self._torch, self.monitor, self.ms = torch, monitor, []

    def __call__(self, stats):
        self._torch.cuda.synchronize()
        t = time.perf_counter()
        self.monitor(stats)
        self._torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t))


def serve_danube(torch, dev, fix_mod, flash_mod, kmod):
    """Phase 7.  Returns the fixmatmul and flash launches of the main path."""
    from repro_torch.config import ServeConfig, get_arch, get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.attention import blocked_attention
    from repro_torch.models.quantized import quantize_params
    from repro_torch.serve import FleetServeMonitor, ServeEngine
    from repro_torch.utils.tree import tree_flatten_with_names, tree_map_with_names

    cfg = get_arch(ARCH)
    model = build_model(cfg, dev)
    t = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in tree_flatten_with_names(params))
    print(f"serve: {ARCH} {cfg.num_layers} layers d {cfg.d_model}, {n_params / 1e9:.3f} B params "
          f"in {cfg.dtype}, drawn on the card in {time.perf_counter() - t:.2f} s", flush=True)

    # (a) prefill through the flash kernel, against the plain attention
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=g, device=dev)
    model.forward(params, {"tokens": tokens[:, :1024]})           # warm-up
    flash_mod.flash_attention.launches = 0
    (logits, _), prefill_ms = timed(torch, lambda: model.forward(params, {"tokens": tokens}))
    launches_flash = flash_mod.flash_attention.launches
    if launches_flash != cfg.num_layers:
        fail(f"prefill launched flash attention {launches_flash} times, not {cfg.num_layers}")
    (ref, _), plain_ms = timed(torch, lambda: model.forward(params, {"tokens": tokens},
                                                            attention=blocked_attention))
    if logits.shape != (1, PREFILL_LEN, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    diff = float((logits.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    print(json.dumps({"phase": "prefill", "batch": 1, "seq": PREFILL_LEN,
                      "window": cfg.sliding_window, "flash_launches": launches_flash,
                      "ms": prefill_ms, "tokens_per_s": PREFILL_LEN / (prefill_ms / 1e3),
                      "plain_attention_ms": plain_ms, "max_abs_logit_diff": diff,
                      "max_abs_logit": scale, "argmax_agreement": agree}), flush=True)
    if diff > PREFILL_REL_TOL * scale:
        fail(f"prefill logits: flash vs plain attention max abs diff {diff} > "
             f"{PREFILL_REL_TOL} x {scale}")
    del logits, ref
    torch.cuda.empty_cache()

    # (b) quantize, then serve with the VM fleet as the measuring job
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    monitor = TimedMonitor(torch, FleetServeMonitor(n=MONITOR_NODES, executor="cuda", device=dev))
    clock = StepClock(torch, model)
    engine = ServeEngine(clock, qparams, ServeConfig(), max_len=PROMPT_LEN + NEW_TOKENS,
                         on_step=monitor)
    rng = torch.Generator().manual_seed(SEED + 3)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), generator=rng).tolist()
    fix_mod.fixmatmul.launches = 0
    kmod.vmloop_call.launches = 0
    t = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    launches_fix = fix_mod.fixmatmul.launches
    launches_vm = kmod.vmloop_call.launches
    steps = len(clock.ms)
    per_step = 7 * cfg.num_layers + 1
    if launches_fix != per_step * steps:
        fail(f"fixmatmul launched {launches_fix} times over {steps} decode steps, "
             f"not {per_step} per step")
    if launches_vm <= 0:
        fail("the serve monitor launched the vmloop kernel no time")
    reports = monitor.monitor.reports()
    if reports != [[SERVE_BATCH] * NEW_TOKENS] * MONITOR_NODES:
        fail(f"monitor reports {sorted({tuple(r) for r in reports})[:2]}, expected "
             f"[{SERVE_BATCH}] * {NEW_TOKENS} on each of {MONITOR_NODES} nodes")
    if [len(o) for o in outs] != [PROMPT_LEN + NEW_TOKENS] * SERVE_BATCH or not all(
            0 <= tok < cfg.vocab_size for o in outs for tok in o):
        fail("generated tokens: wrong count or out of the vocabulary")
    prefill_steps, decode_steps = clock.ms[:PROMPT_LEN], clock.ms[PROMPT_LEN:]
    decode_s = total_s - sum(prefill_steps) / 1e3 - sum(monitor.ms) / 1e3
    print(json.dumps({
        "phase": "serve", "batch": SERVE_BATCH, "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS, "monitor_nodes": MONITOR_NODES,
        "decode_steps": steps, "fixmatmul_launches": launches_fix,
        "fixmatmul_per_step": launches_fix / steps, "vmloop_launches": launches_vm,
        "generate_s": total_s,
        "replay_prefill_tokens_per_s": SERVE_BATCH * PROMPT_LEN / (sum(prefill_steps) / 1e3),
        "decode_tokens_per_s": engine.stats.decode_tokens / decode_s,
        "ms_per_decode_step": sum(decode_steps) / len(decode_steps),
        "monitor_ms_per_step": sum(monitor.ms) / len(monitor.ms),
        "monitor_transfer": monitor.monitor.transfer_stats(),
    }), flush=True)
    print(f"serve: prefill {PREFILL_LEN / (prefill_ms / 1e3):.1f} tokens/s (Model.forward, "
          f"B 1, S {PREFILL_LEN})", flush=True)
    print(f"serve: decode {engine.stats.decode_tokens / decode_s:.1f} tokens/s "
          f"(B {SERVE_BATCH}, monitor excluded)", flush=True)
    print(f"serve: {sum(decode_steps) / len(decode_steps):.3f} ms per decode step", flush=True)
    print(f"serve: monitor {sum(monitor.ms) / len(monitor.ms):.3f} ms per step "
          f"({MONITOR_NODES} nodes, executor=cuda)", flush=True)

    # (d) where a decode step's device time goes
    profile_decode(torch, model, qparams, cfg, dev)
    del qparams, engine
    torch.cuda.empty_cache()

    # (c) small input, held against the CPU: the SMOKE config's quantized
    # decode steps, teacher-forced on one token sequence.  Float sums on
    # the card and the CPU differ in their last bits, which can move an
    # activation's int8 code by one step; SMOKE_TOL bounds what that does
    # to a logit.
    small = get_smoke(ARCH)
    cpu_model, gpu_model = build_model(small, "cpu"), build_model(small, dev)
    p_cpu = quantize_params(cpu_model.init(SEED))
    p_gpu = tree_map_with_names(lambda _, x: x.to(dev), p_cpu)
    toks = torch.randint(0, small.vocab_size, (3, 20), generator=torch.Generator().manual_seed(SEED))
    c_cpu, c_gpu = cpu_model.init_cache(3, 32), gpu_model.init_cache(3, 32)
    worst = 0.0
    for t in range(toks.shape[1]):
        l_cpu, c_cpu = cpu_model.decode_step(p_cpu, c_cpu, toks[:, t:t + 1])
        l_gpu, c_gpu = gpu_model.decode_step(p_gpu, c_gpu, toks[:, t:t + 1].to(dev))
        worst = max(worst, float((l_gpu.cpu() - l_cpu).abs().max()))
    if not worst <= SMOKE_TOL:
        fail(f"SMOKE quantized decode on the card vs the CPU: max abs logit diff {worst}")
    print(f"serve: SMOKE quantized decode, 3 rows x 20 steps (the window-8 cache wraps): "
          f"card vs CPU max abs logit diff {worst:.3g} (tolerance {SMOKE_TOL})", flush=True)
    return launches_fix, launches_flash


def profile_decode(torch, model, qparams, cfg, dev) -> None:
    """Device time of three quantized decode steps by kernel, from
    torch.profiler; the device's busy share of the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + NEW_TOKENS)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int64, device=dev)
    for _ in range(2):
        _, cache = model.decode_step(qparams, cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            _, cache = model.decode_step(qparams, cache, tok)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    from torch.autograd import DeviceType

    groups: dict = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue                      # host ops; their kernels are listed on their own
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        name = ev.key.lower()
        key = ("fixmatmul" if "fixmatmul" in name else
               "memcpy/memset" if "memcpy" in name or "memset" in name else
               "gemm (torch)" if "gemm" in name or "cutlass" in name or "gemv" in name else
               "reduce/softmax" if "reduce" in name or "softmax" in name else
               "elementwise/other")
        groups[key] = groups.get(key, 0.0) + us
    busy = sum(groups.values())
    if busy <= 0:
        print("profile: torch.profiler recorded no device time (not measured)", flush=True)
        return
    print(json.dumps({"phase": "decode_profile", "steps": 3, "wall_ms_per_step": wall_us / 3e3,
                      "device_ms_per_step": {k: v / 3e3 for k, v in sorted(groups.items())},
                      "device_busy_share": busy / wall_us}), flush=True)


def time_fixmatmul(torch, fix_mod, dev) -> dict:
    """ms per launch over the decode step's mix of (K, N) at M = batch, each
    shape timed alone with its weights rotated past the L2 cache."""
    from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    M = SERVE_BATCH
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "n": 0}
    t_bytes_all = t_ops_all = 0.0
    lib_m = None
    for K, N, per_step in danube_gemms():
        xq, wq, sx, sw = fix_operands(torch, M, K, N, dev, g)
        copies = max(2, int(-(-2 * L2_BYTES // (K * N))))
        ws = [wq] + [wq.clone() for _ in range(copies - 1)]
        ms = cuda_ms(torch, lambda i: fix_mod.fixmatmul(xq, ws[i % copies], sx, sw))
        plain = cuda_ms(torch, lambda i: fixmatmul_ref(xq, ws[i % copies], sx, sw), reps=5)
        lib, lib_m = library_int_mm(torch, K, N, ws, sx, sw, dev, g)
        lib_txt = f"{lib:.5f} ms" if lib is not None else "refused"
        nbytes = M * K + K * N + 4 * M + 4 * N + 4 * M * N
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * 2 * M * N * K / INT8_OPS_PER_S
        print(f"fixmatmul timing M={M} K={K} N={N} (x{per_step} per step): {ms:.5f} ms/launch, "
              f"plain {plain:.5f} ms, torch._int_mm+scales at M={lib_m} {lib_txt}, "
              f"bound {max(t_bytes, t_ops):.6f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})",
              flush=True)
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", max(t_bytes, t_ops))):
            tot[key] = None if val is None or tot[key] is None else tot[key] + per_step * val
        t_bytes_all += per_step * t_bytes
        t_ops_all += per_step * t_ops
        tot["n"] += per_step
        del ws
    n = tot.pop("n")
    print(f"fixmatmul: one decode step's {n} launches take {tot['ms']:.4f} ms on the card "
          f"(bound {tot['bound_ms']:.4f} ms)", flush=True)
    return {
        "name": "fixmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/fixmatmul/csrc/fixmatmul.cu",
        "replaces": "src/repro/kernels/fixmatmul/fixmatmul.py:57",
        "ms": tot["ms"] / n, "plain_ms": tot["plain_ms"] / n, "bound_ms": tot["bound_ms"] / n,
        "bound_by": "bytes" if t_bytes_all >= t_ops_all else "operations",
        "library_ms": tot["library_ms"] / n if tot["library_ms"] is not None else None,
    }


def library_int_mm(torch, K, N, ws, sx, sw, dev, g):
    """torch._int_mm plus the two scale multiplies, at the smallest M it
    accepts (it refuses M <= 16).  A yardstick only: the port never calls it."""
    for M in (17, 24, 32):
        xq = torch.randint(-128, 128, (M, K), generator=g, device=dev).to(torch.int8)
        sxm = sx[:1].expand(M).contiguous()
        try:
            fn = lambda i: torch._int_mm(xq, ws[i % len(ws)]).float() * sxm[:, None] * sw[None, :]
            fn(0)
        except RuntimeError:
            continue
        return cuda_ms(torch, fn), M
    return None, None


def time_flash(torch, flash_mod, dev) -> dict:
    """The prefill's shape: B 1, S 8192, 32 heads over 8 KV heads, hd 80,
    causal with a 4096 window, bf16."""
    import torch.nn.functional as F

    from repro_torch.config import get_arch
    from repro_torch.kernels.flashattn.ref import flash_attention_ref

    c = get_arch(ARCH)
    B, S, H, KV, hd, W = 1, PREFILL_LEN, c.num_heads, c.num_kv_heads, c.head_dim, c.sliding_window
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    ms = cuda_ms(torch, lambda i: flash_mod.flash_attention(q, k, v, causal=True, window=W))
    plain = cuda_ms(torch, lambda i: flash_attention_ref(q, k, v, causal=True, window=W),
                    reps=3, warmup=1)
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    try:
        lib_fn = lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        lib_fn(0)
    except TypeError:                     # a torch without enable_gqa: expand the KV heads
        ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        lib_fn = lambda i: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)
    lib = cuda_ms(torch, lib_fn, reps=5, warmup=1)
    visible = sum(min(i + 1, W) for i in range(S))
    flops = 4 * hd * H * B * visible
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    t_ops = 1e3 * flops / BF16_FLOPS
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"flash timing B={B} S={S} H={H} KV={KV} hd={hd} W={W} bf16: {ms:.4f} ms/launch, "
          f"plain {plain:.4f} ms, SDPA with the window as a mask {lib:.4f} ms, "
          f"bound {max(t_ops, t_bytes):.6f} ms ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)",
          flush=True)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flashattn/csrc/flashattn.cu",
        "replaces": "src/repro/kernels/flashattn/flashattn.py:97",
        "ms": ms, "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib,
    }


if __name__ == "__main__":
    sys.exit(main())
