"""Time the bf16 tensor-core flash attention forward at chip_smoke.py
phase 8's shapes, as this checkout builds it, against another checkout's
build of the same kernel (``--parent``: the root of a tree, for instance
the commit before the forward gained its log-sum-exp output, unpacked with
``git archive``), in turns: parent, this tree, this tree, parent.  This
tree's kernel runs as the serve path calls it (``lse`` NULL) and, timed
once more, as the training path does (``lse`` written).  Prints the card,
both builds' ptxas lines (this tree's for both its instances) and, per
shape, each one's ms per launch and the largest difference of their
outputs (the same arithmetic: 0).

    git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/flash_fwd_lse_check.py --parent build/parent

Run from the root of a checkout on a machine with CUDA and nvcc.  The
parent's library is built by the port's ``CudaLibrary`` under
``build/repro_torch/``; whether its entry takes the lse pointer (trees
before the training path's forward do not) is read from its source.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, REPS = 3, 20
# (label, B, H, KV, S, hd, causal, window): danube, qwen2-moe, zamba2, whisper's encoder
SHAPES = [("danube", 1, 32, 8, 8192, 80, True, 4096),
          ("qwen2-moe", 1, 16, 16, 8192, 128, True, None),
          ("zamba2", 1, 32, 32, 8192, 64, True, None),
          ("whisper_encoder", 8, 6, 6, 1500, 64, False, None)]


def ptxas(lib, hd_pad: int, lse: bool = False) -> str:
    """The report of the serve instance or of the one that writes lse
    (``Lb1E`` in its name)."""
    lines = lib.ptxas_lines()
    at = next((i for i, ln in enumerate(lines)
               if f"flash_tc_kernelILi{hd_pad}E" in ln and ("Lb1E" in ln) == lse), None)
    return "no report" if at is None else " | ".join(lines[at + 1:at + 3])


def takes_lse(csrc: str) -> bool:
    """Whether the C entry in ``csrc`` (a flashattn_tc.cu) takes an lse
    pointer after ``out``."""
    sig = re.search(r"flash_attention_tc_launch\(([^)]*)\)", csrc)
    if sig is None:
        sys.exit("no flash_attention_tc_launch in the parent's flashattn_tc.cu")
    return "lse" in sig.group(1)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the checkout to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from pathlib import Path

    from repro_torch.kernels.nvcc import CudaLibrary
    from repro_torch.models.attention import softmax_scale

    fa = importlib.import_module("repro_torch.kernels.flashattn.flashattn")
    parent_csrc = Path(args.parent) / "src/repro_torch/kernels/flashattn/csrc"
    parent_lse = takes_lse((parent_csrc / "flashattn_tc.cu").read_text())
    parent = CudaLibrary("flashattn_tc_parent", parent_csrc, "flashattn_tc.cu", (),
                         fa._binder("flash_attention_tc_launch", 4 + parent_lse, 9))
    libs = {"parent": parent, "this tree": fa.TC_LIBRARY}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, lib in libs.items():
        lib.load()
        for hd_pad in (64, 80, 128):
            print(f"ptxas {name}, flash_tc_kernel<{hd_pad}> (serve): {ptxas(lib, hd_pad)}",
                  flush=True)
            if name == "this tree":
                print(f"ptxas {name}, flash_tc_kernel<{hd_pad}, true> (lse): "
                      f"{ptxas(lib, hd_pad, True)}", flush=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, B, H, KV, S, hd, causal, window in SHAPES:
        g = torch.Generator(device=dev).manual_seed(5)
        q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                   for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
        outs = {name: torch.empty_like(q) for name in ("parent", "this tree", "training")}
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, q) for s in t.stride()[:3]])
        tail = (B, H, KV, S, S, hd, fa.route(q, k, v).hd_pad, int(causal), window or 0,
                softmax_scale(hd), stream)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())

        def launch(name):
            if name == "parent":
                err = parent.load().flash_attention_tc_launch(
                    *ptrs, outs[name].data_ptr(), *((None,) if parent_lse else ()), strides,
                    *tail)
            else:
                err = fa.TC_LIBRARY.load().flash_attention_tc_launch(
                    *ptrs, outs[name].data_ptr(), lse.data_ptr() if name == "training" else None,
                    strides, *tail)
            if err:
                sys.exit(f"{name}: launch failed, CUDA error {err}")

        times = {name: [] for name in outs}
        for name in ("parent", "this tree", "this tree", "parent", "training"):
            for _ in range(WARMUP):
                launch(name)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            start.record()
            for _ in range(REPS):
                launch(name)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / REPS)
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        diff = max(float((outs[n].float() - outs["parent"].float()).abs().max())
                   for n in ("this tree", "training"))
        print(f"{label} B{B} H{H}/KV{KV} S{S} hd{hd} {'causal' if causal else 'non-causal'} "
              f"W{window}: parent {ms['parent']:.4f} ms {times['parent']}, this tree "
              f"{ms['this tree']:.4f} ms {times['this tree']} "
              f"({ms['this tree'] / ms['parent']:.4f}x), with lse {ms['training']:.4f} ms; "
              f"max |out diff| {diff}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
