"""Drive the PyTorch port of the REXAVM fleet on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with CUDA and nvcc.  Phases,
each printing its results on a line of its own:

  1. the card's name and power limit (nvidia-smi);
  2. build the vmloop CUDA kernel from the sources in the checkout;
  3. hold the kernel against its plain PyTorch version on the card: the
     per-opcode sweep and a batch of random node states, byte for byte on
     every field and on n_exec/bailed/bail_op; every claimed word must run
     in the kernel, task/rnd/FIOS must bail;
  4. the main path: FleetVM(VMConfig(), n=4096, executor="cuda"), every
     node running a small fixed-point ANN (vecfold + dotprod + sigmoid),
     then sending its result round a ring; every 16th node also draws `rnd`
     and spawns a task, so the interpreter tail runs on the card.  Run with
     service_every=1 and 8, each held byte for byte against
     executor="batched" on the card; every node must halt;
  5. the kernel's time per launch, its plain version's time, and its bound.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 33.5e12       # H100 SXM non-tensor INT32 rate (data sheet)
N_NODES = 4096
ITERS = 20                      # ANN iterations per node


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
        from repro_torch.config import VMConfig
        from repro_torch.core.vm import FleetVM, REXAVM, vmstate as vms
        from repro_torch.kernels.vmloop import check, vmloop as kmod
        from repro_torch.kernels.vmloop.ref import SUPPORTED_WORDS, core_of, vmloop_ref
    except ImportError as e:
        fail(f"the repository's src/repro_torch is not beside this script ({e})")
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    kmod.build()
    nvcc_s = kmod.build.seconds
    kmod._library()
    print(f"build: vmloop {nvcc_s:.2f} s nvcc, {time.perf_counter() - t0:.2f} s with loading", flush=True)
    regs = [ln.strip() for ln in kmod.build.log.splitlines() if "registers" in ln or "stack frame" in ln]
    print("ptxas: " + " | ".join(regs), flush=True)

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
    print(json.dumps({"kernels": [{
        "name": "vmloop", "route": "cuda",
        "source": "src/repro_torch/kernels/vmloop/csrc/vmloop.cu",
        "replaces": "src/repro/kernels/vmloop/vmloop.py:62",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
