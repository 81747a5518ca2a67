"""Where rwkv6_scan's backward spends its time: variants of
``csrc/rwkv6_scan_bwd.cu``, each built from a text edit of the source and
timed in turns (every variant, then every variant again in reverse order;
CUDA events over 20 calls after 2 warm-ups, the mean of the two turns is
printed).  ``VARIANTS``:

  built        the source as built (bf16 on the tensor cores);
  dstate_only  its dstate pass alone;
  grad_only    its gradient pass alone;

and variants of the gradient pass that each leave one part out, whose
results are wrong (only their times are read):

  no_a         the pairwise pass for A;
  no_pairs     the pairwise pass for dr and dk (its loop over the keys);
  no_dv        the products of dv (A'^T dO and (k kdec)^T G);
  no_d_sd      the products D = dO v^T and S dO;
  no_gv        the product G v;
  no_mma       all three;
  noexp        every exponential (ex2 dropped, its argument kept).

``--baseline DIR`` adds ``baseline``: the ``rwkv6_scan_bwd.cu`` of the
checkout at DIR, built as it stands and timed in turns with the rest (an
older design, say the FP32-pipe one, from a commit unpacked into the
ignored ``build/``).  ``built`` and ``baseline`` are held against the
plain backward (phase 10 (a)'s ``rwkv6_plain_bwd``) at the smaller shape.

Shapes: rwkv6-7b's training path (B 4, H 64, S 4096, K 64) and its serve
prefill (B 1, S 8192), bf16, inputs contiguous as (B, H, S, K), as phase
10 (a) gives them.  At the training shape ``built`` is also timed in
turns with r, k, v, logw and dO laid out as the model passes them
(``ops.wkv``: views of (B, S, H, K) storage).

The forward's two passes (``csrc/rwkv6_scan.cu``, the chunked route) are
timed apart the same way at the serve prefill shape: ``fwd_built``, and
``fwd_state_only`` / ``fwd_output_only``, each with the other pass's
launch taken out.

    mkdir -p build/baseline && git archive <commit> | tar -x -C build/baseline
    python3 scripts/rwkv6_bwd_sweep.py [--baseline build/baseline]

Run from the root of a checkout on a machine with CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = "if (nc < 0) "               # a launch taken out: nc is a chunk count
_NO_TC_DSTATE = [("    rwkv6_dstate_tc_kernel<<<", "    " + NEVER + "rwkv6_dstate_tc_kernel<<<")]
_NO_TC_GRAD = [("    rwkv6_grad_tc_kernel<<<", "    " + NEVER + "rwkv6_grad_tc_kernel<<<")]
_SKIP = "            continue;\n"
_NO_DV = [("            if (ks < mi || 16 * ks >= L) continue;       // t >= i, t < L\n", _SKIP),
          ("            if (16 * ks >= K) continue;\n            uint32_t ah[4]",
           _SKIP + "            uint32_t ah[4]")]
_NO_D_SD = [("            if (16 * ks >= K) continue;\n            uint32_t a[4];\n            ldsm_x4(a, dos",
             _SKIP + "            uint32_t a[4];\n            ldsm_x4(a, dos")]
_NO_GV = [("            if (16 * ks >= K) continue;\n            uint32_t a[4];\n            ldsm_x4(a, vs",
           _SKIP + "            uint32_t a[4];\n            ldsm_x4(a, vs")]
VARIANTS = {
    "built": [],
    "dstate_only": _NO_TC_GRAD,
    "grad_only": _NO_TC_DSTATE,
    "no_a": [("        if (w < 15) {\n            int tb, ib;", "        if (nc < 0) {\n            int tb, ib;"),
             ("        } else {\n            const int d = lane & 15, hz = lane >> 4;",
              "        } else if (nc < 0) {\n            const int d = lane & 15, hz = lane >> 4;")],
    "no_pairs": [("if (8 * n >= t0 + 3) break;", "if (8 * n >= 0) break;")],
    "no_dv": _NO_DV,
    "no_d_sd": _NO_D_SD,
    "no_gv": _NO_GV,
    "no_mma": _NO_DV + _NO_D_SD + _NO_GV,
    "noexp": [("ex2(", "(")],
}
CHECKED = ("built", "baseline")
FWD_VARIANTS = {
    "fwd_built": [],
    "fwd_state_only": [("    rwkv6_chunk_out_kernel<T><<<", "    " + NEVER + "rwkv6_chunk_out_kernel<T><<<")],
    "fwd_output_only": [("    rwkv6_state_kernel<T><<<", "    " + NEVER + "rwkv6_state_kernel<T><<<")],
}
SHAPES = [("train", 4, 4096), ("serve_prefill", 1, 8192)]   # label, B, S


def build(lib, variants: dict, CudaLibrary) -> dict:
    """One library a variant of ``lib``'s source, under
    build/rwkv6_bwd_sweep/<name>/, with the headers it includes copied
    beside it (the flash header at the same relative path)."""
    libs = {}
    for name, edits in variants.items():
        root = Path(HERE) / "build" / "rwkv6_bwd_sweep" / name
        shutil.rmtree(root, ignore_errors=True)
        d = root / "rwkv6_scan" / "csrc"
        d.mkdir(parents=True)
        src = (lib.csrc / lib.main).read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            src = src.replace(old, new)
        (d / lib.main).write_text(src)
        for header in lib.sources[:-1]:
            (d / header).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(lib.csrc / header, d / header)
        libs[name] = CudaLibrary(f"{lib.name}_{name}", d, lib.main, lib.sources[:-1], lib.bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(x.build) for x in libs.values()]:
            fut.result()
    return libs


def in_turns(torch, cuda_ms, libs: dict, swap, call) -> dict:
    """ms a call for each library in ``libs`` swapped in by ``swap``: every
    one, then every one in reverse order."""
    ms = {}
    for name in list(libs) + list(libs)[::-1]:
        swap(libs[name])
        ms.setdefault(name, []).append(cuda_ms(torch, call))
    return ms


def bind_launch(lib) -> None:
    """The backward's launch entry alone: an older source may lack the
    occupancy entry."""
    fn = lib.rwkv6_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def rel_err(outs, refs) -> float:
    return max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(outs, refs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of a checkout whose backward source is timed too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, rwkv6_inputs, rwkv6_plain_bwd
    from repro_torch.kernels.nvcc import CudaLibrary

    rm = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    built, fbuilt = rm.BWD_LIBRARY, rm.LIBRARY
    extra = []
    if args.baseline:
        csrc = Path(args.baseline).resolve() / "src" / "repro_torch" / "kernels" / "rwkv6_scan" / "csrc"
        extra.append(("baseline", CudaLibrary(f"{built.name}_baseline", csrc, built.main, (),
                                              bind_launch)))
    with ThreadPoolExecutor(2 + len(extra)) as pool:
        fb, ff = pool.submit(build, built, VARIANTS, CudaLibrary), pool.submit(
            build, fbuilt, FWD_VARIANTS, CudaLibrary)
        for _, lib in extra:
            pool.submit(lib.build).result()
        libs, flibs = {**fb.result(), **dict(extra)}, ff.result()
    for name, lib in {**libs, **flibs}.items():
        lib.load()
        if name in ("built", "baseline", "fwd_built"):
            print(json.dumps({"variant": name, "ptxas": lib.ptxas_lines()}), flush=True)
    rm.BWD_LIBRARY = libs["built"]
    print(json.dumps({"occupancy_blocks_per_sm": rm.bwd_occupancy(), "card": card}), flush=True)
    dev = torch.device("cuda")

    def swap_bwd(lib):
        rm.BWD_LIBRARY = lib

    def swap_fwd(lib):
        rm.LIBRARY = lib

    try:
        for label, B, S in SHAPES:
            g = torch.Generator(device=dev).manual_seed(S + B)
            r, k, v, logw, u, s0 = rwkv6_inputs(torch, B, 64, S, 64, torch.bfloat16, dev, g)
            dout = torch.randn((B, 64, S, 64), generator=g, device=dev).to(torch.bfloat16)
            ds1 = torch.zeros_like(s0)
            rm.BWD_LIBRARY, rm.LIBRARY = built, fbuilt
            _, _, states = rm._launch(r, k, v, logw, u, s0, 64, keep_states=True)

            def call(i):
                return rm.rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1)

            ms = in_turns(torch, cuda_ms, libs, swap_bwd, call)
            errs = {}
            if label == "serve_prefill":
                refs = rwkv6_plain_bwd(torch, r, k, v, logw, u, s0, dout, ds1)
                outs = {}
                for name in CHECKED:
                    if name in libs:
                        rm.BWD_LIBRARY = libs[name]
                        outs[name] = call(0)
                        errs[name] = rel_err(outs[name], refs)
                if "baseline" in outs:
                    errs["built_vs_baseline"] = rel_err(outs["built"], outs["baseline"])
                del refs, outs
            for name in libs:
                print(json.dumps({"shape": label, "B": B, "S": S, "variant": name,
                                  "ms": sum(ms[name]) / 2, "turns": ms[name],
                                  "rel_err": errs.get(name), "card": card}), flush=True)
            if "built_vs_baseline" in errs:
                print(json.dumps({"shape": label, "built_vs_baseline_rel": errs["built_vs_baseline"]}),
                      flush=True)
            if label == "train":
                # the model's layout: (B, S, H, K) storage seen as (B, H, S, K)
                model = [x.movedim(1, 2).contiguous().movedim(2, 1) for x in (r, k, v, logw, dout)]
                rm.BWD_LIBRARY = built
                calls = {"contiguous": call, "model": lambda i: rm.rwkv6_scan_bwd(
                    *model[:4], u, states, model[4], ds1)}
                lms = {}
                for name in ["contiguous", "model", "model", "contiguous"]:
                    lms.setdefault(name, []).append(cuda_ms(torch, calls[name]))
                err = rel_err(calls["model"](0), calls["contiguous"](0))
                for name, t in lms.items():
                    print(json.dumps({"shape": label, "B": B, "S": S, "variant": "built",
                                      "layout": name, "ms": sum(t) / 2, "turns": t,
                                      "model_vs_contiguous_rel": err, "card": card}), flush=True)
                del model, calls
            if label == "serve_prefill":
                rm.BWD_LIBRARY = built

                def fwd(i):
                    return rm.rwkv6_scan(r, k, v, logw, u, s0)

                fms = in_turns(torch, cuda_ms, flibs, swap_fwd, fwd)
                for name in flibs:
                    print(json.dumps({"shape": label, "B": B, "S": S, "forward_variant": name,
                                      "ms": sum(fms[name]) / 2, "turns": fms[name], "card": card}),
                          flush=True)
            del r, k, v, logw, u, s0, dout, ds1, states
            torch.cuda.empty_cache()
    finally:
        rm.BWD_LIBRARY, rm.LIBRARY = built, fbuilt
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
