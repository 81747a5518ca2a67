"""Split the time of rwkv6_scan's two passes at the rwkv6-7b prefill shape
(B 1, H 64, S 8192, K 64, chunks of 64, bf16) by building variants of
``csrc/rwkv6_scan.cu`` that each leave one piece of work out, and timing
every variant's state pass and output pass (torch.profiler) and both
together (CUDA events) in the same run, in turns: the source as built,
each variant, the variants again in reverse order, the source as built.
A variant that leaves work out gives wrong results; only its time is
read.  ``VARIANTS``:

  st_nostore   the state pass without its stores of each chunk's start state;
  st_noload    the state pass loading only the chunks its prologue loads;
  st_noupdate  the state pass without the k_dec^T v products;
  st_stages2   a ring of two stages (three as built);
  out_noA      the output pass without A (no exponentials of pairs);
  out_noout    the output pass without r_dec @ S + A @ v;
  out_regs128  the output pass allowed 128 registers (two blocks an SM);
  out_unroll   its r_dec @ S and A @ v loops unrolled by four;
  out_oneacc   A @ v summed onto r_dec @ S in one set of accumulators.

    python3 scripts/rwkv6_scan_sweep.py

Run from the root of a checkout on a machine with CUDA and nvcc.  Prints
the card, then one JSON line per timing and one summary line per variant
(the mean of its two turns).
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, S, K, CHUNK = 1, 64, 8192, 64, 64
VARIANTS = {
    "st_nostore": [("""                *reinterpret_cast<float4*>(scr + static_cast<long long>(c) * Kp * Kp + q * Kp + c0) =
                    make_float4(st[0], st[1], st[2], st[3]);
""", "")],
    "st_noload": [("            if (nx < nc)\n", "            if (nx < 0)\n")],
    "st_noupdate": [("for (int i = iq; i < L; i += 4) {", "for (int i = iq; i < 0; i += 4) {")],
    "st_stages2": [("constexpr int NST = 3;", "constexpr int NST = 2;")],
    "out_noA": [("            tile_row(X0, X1, X2, X3, 8 * (warp + 8 * g) + m, ntiles, Kp, jq, res[g]);\n",
                 "            res[g][0] = res[g][1] = res[g][2] = res[g][3] = 0.0f;\n")],
    "out_noout": [("    if (t0 < Lp && j0 < Kp) {\n", "    if (t0 < 0) {\n")],
    "out_regs128": [("__launch_bounds__(CT, 3)", "__launch_bounds__(CT, 2)")],
    "out_unroll": [("        for (int q = 0; q < Kp; ++q) {\n",
                    "#pragma unroll 4\n        for (int q = 0; q < Kp; ++q) {\n"),
                   ("        for (int i = 0; i < iend; ++i) {\n",
                    "#pragma unroll 4\n        for (int i = 0; i < iend; ++i) {\n")],
    "out_oneacc": [("intra[4 * x + y] = fmaf(av[x], vv[y], intra[4 * x + y]);",
                    "inter[4 * x + y] = fmaf(av[x], vv[y], inter[4 * x + y]);"),
                   ("inter[4 * x + y] + intra[4 * x + y] + bn * vv[y]", "inter[4 * x + y] + bn * vv[y]")],
}
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


def pass_ms(torch, fn, reps=5) -> dict:
    """Device ms a launch of each pass, from torch.profiler: its device
    time over the launches it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    us = {"state_pass_ms": [0.0, 0], "output_pass_ms": [0.0, 0]}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        key = ("state_pass_ms" if "rwkv6_state_kernel" in ev.key else
               "output_pass_ms" if "rwkv6_chunk_out_kernel" in ev.key else None)
        if key:
            us[key][0] += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            us[key][1] += ev.count
    return {key: t / 1e3 / max(n, 1) for key, (t, n) in us.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from pathlib import Path

    from repro_torch.kernels.nvcc import CudaLibrary
    rmod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    src = (rmod.CSRC / "rwkv6_scan.cu").read_text()
    libs = {"built": rmod.LIBRARY}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"rwkv6_scan.cu does not hold {old!r} once")
            text = text.replace(old, new)
        d = Path(HERE) / "build" / "rwkv6_scan_sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "rwkv6_scan.cu").write_text(text)
        libs[name] = CudaLibrary(f"rwkv6_scan_{name}", d, "rwkv6_scan.cu", (), rmod.LIBRARY.bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for name, lib in libs.items():
        lib.load()
        print(f"ptxas {name}: " + " | ".join(ln for ln in lib.ptxas_lines()
                                             if "registers" in ln or "spill" in ln), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r, k, v = ((torch.randn((B, H, S, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    logw = -torch.exp(torch.rand((B, H, S, K), generator=g, device=dev) * 2 - 6)
    u = torch.randn((H, K), generator=g, device=dev) * 0.5
    s0 = torch.randn((B, H, K, K), generator=g, device=dev) * 0.1

    def call(i):
        return rmod.rwkv6_scan(r, k, v, logw, u, s0, chunk=CHUNK, kernel="chunked")

    names = list(libs)
    order = names + list(reversed(names))            # built, variants, variants reversed, built
    runs: dict = {name: [] for name in names}
    for name in order:
        rmod.LIBRARY = libs[name]
        rec = {"ms": cuda_ms(torch, call), **pass_ms(torch, call)}
        runs[name].append(rec)
        print(json.dumps({"phase": "turn", "variant": name, **rec}), flush=True)
    rmod.LIBRARY = libs["built"]
    for name in names:
        mean = {key: sum(x[key] for x in runs[name]) / len(runs[name]) for key in runs[name][0]}
        print(json.dumps({"phase": "variant", "variant": name, **mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
