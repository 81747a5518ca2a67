"""Time variants of the bf16 flash attention backward
(``csrc/flashattn_bwd.cu``, the tensor-core kernels), each built from a
text edit of the source, in turns: every variant, then every variant again
in reverse order, CUDA events over 20 calls after 2 warm-ups (the mean of
the two turns is printed).  Each variant is held against the plain
version (``ref.flash_attention_bwd_ref``, the largest relative error of
dq, dk and dv; not at danube's B 4, where the plain version is slow), and
one profiled call splits its time into rowdot, dK/dV and dQ.
``VARIANTS``:

  built   the source as built (8 warps a block, 64 queries a dK/dV step,
          64 keys a dQ step, one block an SM);
  w4      4 warps a block (64 keys or queries), two blocks an SM;
  bq32    32 queries a dK/dV step (fewer registers, twice the steps);
  bk32    32 keys a dQ step;

and two that leave work out, whose results are wrong (only their times
are read): ``noexp`` computes P without ex2 (the SFU's share), ``nold_t``
takes the B fragments of dV, dK and dQ from registers instead of by
ldmatrix.trans (half of the dK/dV kernel's shared-memory reads and a
third of the dQ kernel's).

Shapes: danube's (B 1 and the training path's B 4, H 32/8, S 4096, hd
80, window 4096), whisper's encoder (B 8, H 6, S 1500, non-causal),
qwen2-moe's hd 128 and zamba2's hd 64 (causal, S 4096).

    python3 scripts/flash_bwd_sweep.py

Run from the root of a checkout on a machine with CUDA and nvcc.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "built": [],
    "w4": [("constexpr int TC_WARPS = 8;", "constexpr int TC_WARPS = 4;"),
           ("__launch_bounds__(TC_THREADS, 1)", "__launch_bounds__(TC_THREADS, 2)")],
    "bq32": [("constexpr int BQ_TC = 64;", "constexpr int BQ_TC = 32;")],
    "bk32": [("constexpr int BK_TC = 64;", "constexpr int BK_TC = 32;")],
    "noexp": [("ok ? ex2(fmaf(s, scale_log2, -lse_log2))", "ok ? fmaf(s, scale_log2, -lse_log2)")],
    "nold_t": [("ldsm_x4_t(bo, dost + t_off + (kk * 16 * LD + d * 16) * E);",
                "bo[0] = bo[1] = bo[2] = bo[3] = pa[d & 3];"),
               ("ldsm_x4_t(bq, qst + t_off + (kk * 16 * LD + d * 16) * E);",
                "bq[0] = bq[1] = bq[2] = bq[3] = da[d & 3];"),
               ("ldsm_x4_t(bk, kst + t_off + (kk * 16 * LD + d * 16) * E);",
                "bk[0] = bk[1] = bk[2] = bk[3] = da[d & 3];")],
}
WRONG = ("noexp", "nold_t")       # leave work out: their results are not checked
SHAPES = [  # label, B, H, KV, S, hd, causal, window
    ("danube", 1, 32, 8, 4096, 80, True, 4096),
    ("danube_B4", 4, 32, 8, 4096, 80, True, 4096),
    ("whisper_encoder", 8, 6, 6, 1500, 64, False, None),
    ("qwen2-moe_hd128", 1, 16, 16, 4096, 128, True, None),
    ("zamba2_hd64", 1, 32, 32, 4096, 64, True, None),
]


def build(fm, CudaLibrary) -> dict:
    """One library a variant, under build/flash_bwd_sweep/<name>/."""
    libs = {}
    for name, edits in VARIANTS.items():
        d = Path(HERE) / "build" / "flash_bwd_sweep" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in fm.BWD_LIBRARY.sources:
            shutil.copy(fm.CSRC / f, d / f)
        src = (d / fm.BWD_LIBRARY.main).read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            src = src.replace(old, new)
        (d / fm.BWD_LIBRARY.main).write_text(src)
        libs[name] = CudaLibrary(f"flashattn_bwd_{name}", d, fm.BWD_LIBRARY.main,
                                 fm.BWD_LIBRARY.sources[:-1], fm.BWD_LIBRARY.bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs.values()]:
            fut.result()
    return libs


def kernel_ms(torch, call) -> dict:
    """Device ms a call by kernel (rowdot, dkdv, dq), from three profiled calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call(0)
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        name = next((k for k in ("rowdot", "dkdv", "dq") if k in ev.key), None)
        if us > 0 and name:
            per[name] = per.get(name, 0.0) + us / 3e3
    return per


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, ptxas_of
    from repro_torch.kernels.flashattn.ref import flash_attention_bwd_ref
    from repro_torch.kernels.nvcc import CudaLibrary

    fm = importlib.import_module("repro_torch.kernels.flashattn.flashattn")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build(fm, CudaLibrary)
    for name, lib in libs.items():
        lib.load()
        for p in (64, 80, 128):
            print(json.dumps({"variant": name, "hd_pad": p, "ptxas": {
                k: " | ".join(ptxas_of(lib, f"{k}_kernelILi{p}E")[1:])
                for k in ("dkdv_tc", "dq_tc")}}), flush=True)
    dev, built = torch.device("cuda"), fm.BWD_LIBRARY
    for label, B, H, KV, S, hd, causal, window in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + hd)
        q, k, v, dout = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                         for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
        out, lse = fm.flash_attention_fwd(q, k, v, causal=causal, window=window)
        refs = None if B == 4 else flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                            causal=causal, window=window)

        def call(i):
            return fm.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)

        ms = {}
        try:
            for name in list(libs) + list(libs)[::-1]:
                fm.BWD_LIBRARY = libs[name]
                ms.setdefault(name, []).append(cuda_ms(torch, call))
            for name, lib in libs.items():
                fm.BWD_LIBRARY = lib
                grads = call(0)
                torch.cuda.synchronize()
                err = None if refs is None or name in WRONG else max(
                    float((a.float() - b.float()).abs().max() / b.float().abs().max())
                    for a, b in zip(grads, refs))
                print(json.dumps({"shape": label, "variant": name, "ms": sum(ms[name]) / 2,
                                  "turns": ms[name], "rel_err": err,
                                  "kernels_ms": kernel_ms(torch, call)}), flush=True)
        finally:
            fm.BWD_LIBRARY = built
        del q, k, v, dout, out, lse, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
