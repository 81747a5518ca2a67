"""Where rwkv6_scan's backward spends its time: variants of
``csrc/rwkv6_scan_bwd.cu``, each built from a text edit of the source and
timed in turns (every variant, then every variant again in reverse order;
CUDA events over 20 calls after 2 warm-ups, the mean of the two turns is
printed), with one profiled call split into the dstate pass and the
gradient pass.  ``VARIANTS``: ``built``, the source as built, and
variants that each leave one part of the gradient pass out, whose results
are wrong (only their times are read):

  no_products  D, S dO and G v (the block's dense products);
  no_a         A over the pairs;
  no_dv        dv;
  no_pairs     the pairwise pass for dr and dk;
  noexp        every exponential of the gradient pass (exp2f dropped, its
               argument kept).

``built`` is held against the plain backward (phase 10 (a)'s
``rwkv6_plain_bwd``) at the smaller shape.  Shapes: rwkv6-7b's training
path (B 4, H 64, S 4096, K 64) and its serve prefill (B 1, S 8192), bf16.

    python3 scripts/rwkv6_bwd_sweep.py

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
    "no_products": [("for (int e = tid; e < L * L4; e += GT) {", "for (int e = tid; e < 0; e += GT) {"),
                    ("for (int e = tid; e < L * K4; e += GT) {\n        const int t = e % L, q0",
                     "for (int e = tid; e < 0; e += GT) {\n        const int t = e % L, q0")],
    "no_a": [("for (int n = tid; n < npairs; n += GT) {", "for (int n = tid; n < 0; n += GT) {")],
    "no_dv": [("for (int e = tid; e < L * K4; e += GT) {\n        const int i = e % L, j0",
               "for (int e = tid; e < 0; e += GT) {\n        const int i = e % L, j0")],
    "no_pairs": [("        for (int t = 0; t < L; ++t) {\n            const float et",
                  "        for (int t = 0; t < 0; ++t) {\n            const float et")],
    "noexp": [("exp2f(", "(")],
}
SHAPES = [("train", 4, 4096), ("serve_prefill", 1, 8192)]   # label, B, S


def build(rm, CudaLibrary) -> dict:
    """One library a variant, under build/rwkv6_bwd_sweep/<name>/.  The
    variants other than ``noexp`` edit the gradient pass only."""
    libs = {}
    for name, edits in VARIANTS.items():
        d = Path(HERE) / "build" / "rwkv6_bwd_sweep" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        src = (rm.CSRC / rm.BWD_LIBRARY.main).read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            src = src.replace(old, new)
        (d / rm.BWD_LIBRARY.main).write_text(src)
        libs[name] = CudaLibrary(f"rwkv6_scan_bwd_{name}", d, rm.BWD_LIBRARY.main, (),
                                 rm.BWD_LIBRARY.bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs.values()]:
            fut.result()
    return libs


def pass_ms(torch, call) -> dict:
    """Device ms a call of each pass, from three profiled calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call(0)
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        name = next((k for k in ("dstate", "grad") if f"rwkv6_{k}_kernel" in ev.key), None)
        if us > 0 and name:
            per[name] = per.get(name, 0.0) + us / 3e3
    return per


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, rwkv6_inputs, rwkv6_plain_bwd
    from repro_torch.kernels.nvcc import CudaLibrary

    rm = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build(rm, CudaLibrary)
    for name, lib in libs.items():
        lib.load()
        print(json.dumps({"variant": name, "ptxas": lib.ptxas_lines()}), flush=True)
    dev, built = torch.device("cuda"), rm.BWD_LIBRARY
    for label, B, S in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + B)
        r, k, v, logw, u, s0 = rwkv6_inputs(torch, B, 64, S, 64, torch.bfloat16, dev, g)
        dout = torch.randn((B, 64, S, 64), generator=g, device=dev).to(torch.bfloat16)
        ds1 = torch.zeros_like(s0)
        _, _, states = rm._launch(r, k, v, logw, u, s0, 64, keep_states=True)

        def call(i):
            return rm.rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1)

        ms = {}
        try:
            for name in list(libs) + list(libs)[::-1]:
                rm.BWD_LIBRARY = libs[name]
                ms.setdefault(name, []).append(cuda_ms(torch, call))
            err = None
            if label == "serve_prefill":
                rm.BWD_LIBRARY = built
                grads = call(0)
                refs = rwkv6_plain_bwd(torch, r, k, v, logw, u, s0, dout, ds1)
                err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                          for a, b in zip(grads, refs))
                del grads, refs
            for name, lib in libs.items():
                rm.BWD_LIBRARY = lib
                print(json.dumps({"shape": label, "B": B, "S": S, "variant": name,
                                  "ms": sum(ms[name]) / 2, "turns": ms[name],
                                  "rel_err": err if name == "built" else None,
                                  "passes_ms": pass_ms(torch, call)}), flush=True)
        finally:
            rm.BWD_LIBRARY = built
        del r, k, v, logw, u, s0, dout, ds1, states
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
