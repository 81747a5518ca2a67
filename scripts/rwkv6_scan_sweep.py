"""Time variants of ``csrc/rwkv6_scan.cu``, built from its text, in turns:
the source as built, each variant, the variants again in reverse order,
the source as built.  Two parts:

prefill — split the time of rwkv6_scan's two passes at the rwkv6-7b
prefill shape (B 1, H 64, S 8192, K 64, chunks of 64, bf16) by variants
that each leave one piece of work out, timing every variant's state pass
and output pass (torch.profiler) and both together (CUDA events).  A
variant that leaves work out gives wrong results; only its time is read.
``VARIANTS``:

  st_nostore   the state pass without its stores of each chunk's start state;
  st_noload    the state pass loading only the chunks its prologue loads;
  st_noupdate  the state pass without the k_dec^T v products;
  st_stages2   a ring of two stages (three as built);
  out_noA      the output pass without A (no exponentials of pairs);
  out_noout    the output pass without r_dec @ S + A @ v;
  out_regs128  the output pass allowed 128 registers (two blocks an SM);
  out_unroll   its r_dec @ S and A @ v loops unrolled by four;
  out_oneacc   A @ v summed onto r_dec @ S in one set of accumulators.

decode — the decode kernel's design at the rwkv6-7b decode step (B 8,
H 64, S 1, K 64, bf16; the states rotate through copies past the L2
cache, as 32 layers' states find it cold), beside the one-block kernel
(``kernel="one_block"``, the source as built) in the same turns.  Every
variant computes the full result and is held to ``decode_ref`` (out
within 1e-2, the state within 1e-4 of the largest value).
``DECODE_VARIANTS``: ``kc<columns a tile>_w<warps a tile>`` (the source
as built is kc16_w2), and

  nopdl        launched without programmatic dependence;
  trigger      griddepcontrol.launch_dependents right after the wait, so
               that the next programmatic dependent is placed early;
  smem         the state staged through shared memory, with a barrier
               before r, k, v, logw and u are loaded (the one-block
               kernel's order).

    python3 scripts/rwkv6_scan_sweep.py [--part prefill|decode|all]

Run from the root of a checkout on a machine with CUDA and nvcc.  Prints
the card, then one JSON line per timing and one summary line per variant
(the mean of its two turns).
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
TILE = ("constexpr int DKC = 16;", "constexpr int DWARPS = 2;")


def tile(kc: int, warps: int) -> list:
    return [(TILE[0], f"constexpr int DKC = {kc};"), (TILE[1], f"constexpr int DWARPS = {warps};")]


DECODE_B, DECODE_H, DECODE_K = 8, 64, 64
DECODE_REPS = 200
DECODE_VARIANTS = {
    **{f"kc{kc}_w{w}": tile(kc, w) for kc, w in ((8, 2), (16, 1), (16, 4), (32, 1), (32, 2),
                                                  (32, 4), (64, 4), (64, 8), (64, 16))},
    "nopdl": [("    cfg.numAttrs = 1;\n    return static_cast<int>(cudaLaunchKernelEx(\n"
               "        &cfg, rwkv6_decode_kernel<T>",
               "    cfg.numAttrs = 0;\n    return static_cast<int>(cudaLaunchKernelEx(\n"
               "        &cfg, rwkv6_decode_kernel<T>")],
    "trigger": [('    asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n\n    // every load',
                 '    asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'
                 '    asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n\n'
                 '    // every load')],
    "smem": [("    float rr[DRPT], kk[DRPT], ww[DRPT], uu[DRPT], vv[4];\n",
              "    __shared__ float4 stage[DRPT][32 * DWARPS];\n"
              "#pragma unroll\n    for (int i = 0; i < DRPT; ++i) stage[i][tid] = st[i];\n"
              "    __syncthreads();\n"
              "#pragma unroll\n    for (int i = 0; i < DRPT; ++i) st[i] = stage[i][tid];\n"
              "    float rr[DRPT], kk[DRPT], ww[DRPT], uu[DRPT], vv[4];\n")],
}
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


def ptxas_of(lib, kernel: str | None) -> list:
    """The register and spill lines of ``lib``'s last compile: of every
    kernel, or of each instance of ``kernel`` (its line says which)."""
    lines = lib.ptxas_lines()
    if kernel is None:
        return [ln for ln in lines if "registers" in ln or "spill" in ln]
    out = []
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and kernel in ln:
            out += ["bf16" if "bfloat16" in ln else "f32"] + [
                x for x in lines[i + 1:i + 3] if "registers" in x or "spill" in x]
    return out


def build(rmod, variants: dict, tag: str, kernel: str | None = None) -> dict:
    """The source as built and one library per variant, built together
    (the source as built in a directory of its own, so that its report is
    printed too)."""
    from pathlib import Path

    from repro_torch.kernels.nvcc import CudaLibrary

    src = (rmod.CSRC / "rwkv6_scan.cu").read_text()
    libs = {}
    for name, edits in {"built": [], **variants}.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"rwkv6_scan.cu does not hold {old!r} once")
            text = text.replace(old, new)
        d = Path(HERE) / "build" / "rwkv6_scan_sweep" / f"{tag}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "rwkv6_scan.cu").write_text(text)
        libs[name] = CudaLibrary(f"rwkv6_scan_{tag}_{name}", d, "rwkv6_scan.cu", (),
                                 rmod.LIBRARY.bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for name, lib in libs.items():
        lib.load()
        print(f"ptxas {tag} {name}: " + " | ".join(ptxas_of(lib, kernel)), flush=True)
    return libs


def in_turns(rmod, libs: dict, timings: dict, tag: str) -> None:
    """Each (name, fn) of ``timings`` run with its library (the name up to
    a "/" picks it) in turns; one JSON line a turn, one a name."""
    names = list(timings)
    order = names + list(reversed(names))
    runs: dict = {name: [] for name in names}
    for name in order:
        rmod.LIBRARY = libs[name.split("/")[0]]
        rec = timings[name]()
        runs[name].append(rec)
        print(json.dumps({"phase": f"{tag}_turn", "variant": name, **rec}), flush=True)
    rmod.LIBRARY = libs["built"]
    for name in names:
        mean = {key: sum(x[key] for x in runs[name]) / len(runs[name]) for key in runs[name][0]}
        print(json.dumps({"phase": f"{tag}_variant", "variant": name, **mean}), flush=True)


def prefill(torch, rmod, dev) -> None:
    libs = build(rmod, VARIANTS, "prefill")
    g = torch.Generator(device=dev).manual_seed(0)
    r, k, v = ((torch.randn((B, H, S, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    logw = -torch.exp(torch.rand((B, H, S, K), generator=g, device=dev) * 2 - 6)
    u = torch.randn((H, K), generator=g, device=dev) * 0.5
    s0 = torch.randn((B, H, K, K), generator=g, device=dev) * 0.1

    def call(i):
        return rmod.rwkv6_scan(r, k, v, logw, u, s0, chunk=CHUNK, kernel="chunked")

    in_turns(rmod, libs, {name: lambda: {"ms": cuda_ms(torch, call), **pass_ms(torch, call)}
                          for name in libs}, "prefill")


def decode(torch, rmod, dev) -> None:
    from repro_torch.kernels.rwkv6_scan.ref import decode_ref

    libs = build(rmod, DECODE_VARIANTS, "decode", "rwkv6_decode_kernel")
    Bd, Hd, Kd = DECODE_B, DECODE_H, DECODE_K
    g = torch.Generator(device=dev).manual_seed(1)
    r, k, v = ((torch.randn((Bd, Hd, 1, Kd), generator=g, device=dev) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    logw = -torch.exp(torch.rand((Bd, Hd, 1, Kd), generator=g, device=dev) * 2 - 6)
    u = torch.randn((Hd, Kd), generator=g, device=dev) * 0.5
    s0 = torch.randn((Bd, Hd, Kd, Kd), generator=g, device=dev) * 0.1
    copies = int(-(-2 * L2_BYTES // (4 * s0.numel())))
    states = [s0] + [s0.clone() for _ in range(copies - 1)]
    ref, ref_s1 = decode_ref(r, k, v, logw, u, s0)
    for name, lib in libs.items():
        rmod.LIBRARY = lib
        out, s1 = rmod.rwkv6_scan(r, k, v, logw, u, s0, kernel="decode")
        torch.cuda.synchronize()
        rel = float((out.float() - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        s_rel = float((s1 - ref_s1).abs().max()) / max(1.0, float(ref_s1.abs().max()))
        if rel > 1e-2 or s_rel > 1e-4:
            sys.exit(f"decode variant {name}: out {rel}, state {s_rel} against decode_ref")
    rmod.LIBRARY = libs["built"]

    def timing(kern):
        return lambda: {"ms": cuda_ms(torch, lambda i: rmod.rwkv6_scan(
            r, k, v, logw, u, states[i % copies], kernel=kern), reps=DECODE_REPS)}

    timings = {name: timing("decode") for name in libs}
    timings["built/one_block"] = timing("one_block")
    in_turns(rmod, libs, timings, "decode")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("prefill", "decode", "all"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    rmod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.part in ("prefill", "all"):
        prefill(torch, rmod, dev)
    if args.part in ("decode", "all"):
        decode(torch, rmod, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
