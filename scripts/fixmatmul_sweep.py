"""Time fixmatmul's streaming kernel over its launch plans at M = 8, the
decode batch, on the decode shapes of h2o-danube-1.8b and rwkv6-7b:
column tiles of 128 with 1, 2, 4 and 8 K splits and of 64 with 1, 4 and 8
(``--all-plans``: both tiles with 1 to 8 splits), and the plan that
``fixmatmul.plan`` picks, marked; each plan is held bitwise equal to the
plain version.  First the fixed cost of a launch: plans at K = 0 (no
weight bytes: the launch, the barriers, the epilogue), and a one-element
``add_`` as the card's floor for any launch.  Each source variant in
``VARIANTS`` (no programmatic dependent launch, a deeper ring, L2
prefetch hints on the copies, a looser register cap, an empty kernel) is
built beside the source as it stands and timed in the same run, in turns;
those in ``K0_ONLY`` do not compute the product, so they are timed at
K = 0 alone.

    python3 scripts/fixmatmul_sweep.py [--shapes 2560x640,2560x2560]

Run from the root of a checkout on a machine with CUDA and nvcc.  Prints
the card, one JSON line per (variant, shape, plan) and a summary line per
shape: the best plan and the planner's.  Weights rotate through copies
past the 50 MB L2, as a decode step finds them cold.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 8
SHAPES = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560), (2560, 32000), (4096, 65536)]
STAGES_LINE = "constexpr int STAGES = 4;"
CP_ASYNC = '"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"'
VARIANTS = {
    # without programmatic dependent launch: each launch waits for the
    # previous kernel to complete before its blocks are placed
    "nopdl": [('    asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n', ""),
              ("programmaticStreamSerializationAllowed = 1;", "programmaticStreamSerializationAllowed = 0;")],
    "stages6": [(STAGES_LINE, "constexpr int STAGES = 6;")],
    # the copies ask L2 to fetch 128 or 256 bytes around each 16
    "l2_128": [(CP_ASYNC, CP_ASYNC.replace(".global ", ".global.L2::128B "))],
    "l2_256": [(CP_ASYNC, CP_ASYNC.replace(".global ", ".global.L2::256B "))],
    # up to 128 registers a thread (two blocks an SM) instead of 64 (four)
    "minblocks2": [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 2)")],
    # the launch alone: every block returns at once
    "empty": [("    using S = Stream<BN, MR>;\n", "    using S = Stream<BN, MR>;\n    if (K >= 0) return;\n")],
}
K0_ONLY = {"empty"}
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
SPIN_CYCLES = 50_000_000


def cuda_ms(torch, fn, reps=20, warmup=2) -> float:
    """Mean ms a call over ``reps`` calls queued behind a spin kernel."""
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


def plans(fix, K, picked, everything):
    """The planner's pick, then the swept (tile, splits), as the planner
    would size their K ranges."""
    steps = max(1, -(-K // fix.STREAM_K_STEP))
    grid = [(t, s) for t in fix.STREAM_TILES for s in range(1, fix.MAX_CLUSTER + 1)] if everything \
        else [(128, 1), (128, 2), (128, 4), (128, 8), (64, 1), (64, 4), (64, 8)]
    out = [picked]
    for tile, splits in grid:
        per = -(-steps // min(splits, steps))
        p = fix.Plan("stream", tile, -(-steps // per), per * fix.STREAM_K_STEP)
        if p not in out:
            out.append(p)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None, help="KxN,KxN,... (default: all decode shapes)")
    ap.add_argument("--all-plans", action="store_true", help="every tile with 1 to 8 splits")
    args = ap.parse_args()
    shapes = SHAPES if args.shapes is None else [
        tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    sys.path.insert(0, os.path.join(HERE, "src"))
    from pathlib import Path

    from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref
    from repro_torch.kernels.nvcc import CudaLibrary, sm_count
    fix = importlib.import_module("repro_torch.kernels.fixmatmul.fixmatmul")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    src = (fix.CSRC / "fixmatmul.cu").read_text()
    libs = {"built": fix.LIBRARY}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"fixmatmul.cu does not hold {old!r} once")
            text = text.replace(old, new)
        d = Path(HERE) / "build" / "fixmatmul_sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fixmatmul.cu").write_text(text)
        libs[name] = CudaLibrary(f"fixmatmul_{name}", d, "fixmatmul.cu", (), fix.LIBRARY.bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for name, lib in libs.items():
        lib.load()
        print(f"ptxas {name}: " + " | ".join(ln for ln in lib.ptxas_lines()
                                             if "registers" in ln or "spill" in ln), flush=True)
    built = fix.LIBRARY
    dev = torch.device("cuda")
    sms = sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)

    tiny = torch.zeros(1, device=dev)
    floor = cuda_ms(torch, lambda i: tiny.add_(1))
    print(json.dumps({"phase": "floor", "what": "one-element add_", "ms": floor}), flush=True)
    for N in (640, 2560):
        xq = torch.zeros((M, 0), dtype=torch.int8, device=dev)
        wq = torch.zeros((0, N), dtype=torch.int8, device=dev)
        sx, sw = torch.ones(M, device=dev), torch.ones(N, device=dev)
        for tile in fix.STREAM_TILES:
            for splits in (1, 4, 8):
                p = fix.Plan("stream", tile, splits, fix.STREAM_K_STEP)
                ts = {}
                for name in list(libs) + list(reversed(libs)):
                    fix.LIBRARY = libs[name]
                    try:
                        ts.setdefault(name, []).append(
                            cuda_ms(torch, lambda i: fix.launch(xq, wq, sx, sw, p)))
                    finally:
                        fix.LIBRARY = built
                print(json.dumps({"phase": "k0", "N": N, "plan": p._asdict(), "blocks": -(-N // tile) * splits,
                                  "ms": {k: sum(v) / len(v) for k, v in ts.items()}}), flush=True)

    full = [name for name in libs if name not in K0_ONLY]
    order = full + list(reversed(full))                # built, variants, variants reversed, built
    for K, N in shapes:
        xq = torch.randint(-128, 128, (M, K), generator=g, device=dev).to(torch.int8)
        wq = torch.randint(-128, 128, (K, N), generator=g, device=dev).to(torch.int8)
        sx = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
        sw = torch.rand(N, generator=g, device=dev) * 0.05 + 1e-3
        copies = max(2, int(-(-2 * L2_BYTES // (K * N))))
        ws = [wq] + [wq.clone() for _ in range(copies - 1)]
        ref = fixmatmul_ref(xq, wq, sx, sw)
        bound = 1e3 * (M * K + K * N + 4 * M + 4 * N + 4 * M * N) / HBM_BYTES_PER_S
        picked = fix.plan(M, K, N, sms)
        times: dict = {}
        for p in plans(fix, K, picked, args.all_plans):
            for name in order:
                fix.LIBRARY = libs[name]
                try:
                    if not torch.equal(fix.launch(xq, wq, sx, sw, p), ref):
                        sys.exit(f"{name} {p} at {(M, K, N)}: kernel != plain version")
                    ms = cuda_ms(torch, lambda i: fix.launch(xq, ws[i % copies], sx, sw, p))
                finally:
                    fix.LIBRARY = built
                times.setdefault((name, p), []).append(ms)
        for (name, p), ts in times.items():
            ms = sum(ts) / len(ts)
            blocks = -(-N // p.tile) * p.splits
            print(json.dumps({"phase": "plan", "variant": name, "M": M, "K": K, "N": N,
                              "plan": p._asdict(), "blocks": blocks, "ms": ms, "turns_ms": ts,
                              "bound_ms": bound, "x_bound": ms / bound, "picked": p == picked}),
                  flush=True)
        best = min(times, key=lambda key: sum(times[key]))
        pick = sum(times["built", picked]) / len(times["built", picked])
        print(json.dumps({"phase": "best", "M": M, "K": K, "N": N, "bound_ms": bound,
                          "best": {"variant": best[0], "plan": best[1]._asdict(),
                                   "ms": sum(times[best]) / len(times[best])},
                          "planner": {"plan": picked._asdict(), "ms": pick}}), flush=True)
        del ws, wq
    return 0


if __name__ == "__main__":
    sys.exit(main())
