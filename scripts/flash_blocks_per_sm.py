"""Time the bf16 tensor-core flash attention kernel as built (two blocks an
SM for head widths up to 80, which caps it at 128 registers a thread)
against the same source with one block an SM (no cap, no spills), at
h2o-danube-1.8b's prefill shape: B 1, S 8192, 32 heads over 8 KV heads,
hd 80, causal with a 4096 window.

    python3 scripts/flash_blocks_per_sm.py

Run from the root of a checkout on a machine with CUDA and nvcc.  The
variant's source is written under ``build/`` and built by the port's
``CudaLibrary``; both go through ``flash_attention`` (the variant swapped
in as its library), in the order built, variant, variant, built.  Prints
the card, each build's ptxas line for the hd 80 instance, and each one's
ms per launch and TFLOP/s.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = "__launch_bounds__(THREADS, HD_PAD <= 80 ? 2 : 1)"
WARMUP, REPS = 3, 20


def ptxas_hd80(lib) -> str:
    """The register, stack and spill lines that follow the hd 80 instance
    (the serve path's, without the lse output)."""
    lines = lib.ptxas_lines()
    at = next((i for i, ln in enumerate(lines)
               if "flash_tc_kernelILi80E" in ln and "Lb1E" not in ln), None)
    if at is None:
        return "no report (the library was built by an earlier process)"
    return " | ".join(lines[at + 1:at + 3])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from pathlib import Path

    from repro_torch.kernels.nvcc import CudaLibrary
    fa = importlib.import_module("repro_torch.kernels.flashattn.flashattn")

    src = (fa.CSRC / "flashattn_tc.cu").read_text()
    if BOUNDS not in src:
        sys.exit(f"flashattn_tc.cu no longer holds {BOUNDS!r}")
    var_dir = Path(HERE) / "build" / "flash_blocks_per_sm"
    var_dir.mkdir(parents=True, exist_ok=True)
    (var_dir / "flashattn_tc.cu").write_text(
        src.replace(BOUNDS, "__launch_bounds__(THREADS, 1)"))
    libs = {"2 blocks an SM (built)": fa.TC_LIBRARY,
            "1 block an SM": CudaLibrary("flashattn_tc_1blk", var_dir, "flashattn_tc.cu", (),
                                         fa.TC_LIBRARY.bind)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, lib in libs.items():
        lib.load()
        print(f"ptxas {name}, flash_tc_kernel<80>: {ptxas_hd80(lib)}", flush=True)

    dev = torch.device("cuda")
    B, S, H, KV, hd, W = 1, 8192, 32, 8, 80, 4096
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    flops = 4 * hd * H * B * sum(min(i + 1, W) for i in range(S))
    built = fa.TC_LIBRARY
    outs, times = {}, {name: [] for name in libs}
    for name in (*libs, *reversed(libs)):
        fa.TC_LIBRARY = libs[name]
        tc = fa.flash_attention.tc_launches
        for _ in range(WARMUP):
            outs[name] = fa.flash_attention(q, k, v, causal=True, window=W)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fa.flash_attention(q, k, v, causal=True, window=W)
        end.record()
        torch.cuda.synchronize()
        if fa.flash_attention.tc_launches - tc != WARMUP + REPS:
            sys.exit(f"{name}: the launches did not take the tensor-core kernel")
        times[name].append(start.elapsed_time(end) / REPS)
    fa.TC_LIBRARY = built
    a, b = outs.values()
    diff = float((a.float() - b.float()).abs().max())
    print(f"max abs difference between the two builds' outputs: {diff}", flush=True)
    if diff > 2e-2:
        sys.exit("the two builds disagree beyond the bf16 tolerance (2e-2)")
    for name, ms in times.items():
        print(f"{name}: {ms} ms per launch, {flops / (min(ms) * 1e-3) / 1e12:.1f} TFLOP/s "
              f"(best of the two turns)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
