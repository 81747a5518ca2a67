"""Where a training step's device time goes: h2o-danube-1.8b whole (24
layers, bf16, AdamW, remat) at seq 4096 and batch 4, as ``chip_smoke.py``
phase 9 (b) trains it, or another arch (``--arch``, with ``--layers`` of
its layers: rwkv6-7b with 12, as phase 10 (b)), one step under
``torch.profiler`` after two unprofiled ones.  Prints the card, the
step's wall ms, the device's busy ms, and its kernel time by group:
rwkv6_scan's backward (``csrc/rwkv6_scan_bwd.cu``: the dstate and
gradient passes, on the tensor cores in bf16) and forward (``csrc/rwkv6_scan.cu``), flash attention's
backward (the kernels of ``csrc/flashattn_bwd.cu``: rowdot and, in bf16,
the tensor-core ``dkdv_tc_kernel`` and ``dq_tc_kernel``), its forward
(``flash_tc_kernel``, both instances), the matrix products (cuBLAS /
CUTLASS: ``gemm``, ``nvjet``, ``cutlass``, ``sm90_xmma``), and the rest
(elementwise work, reductions, the optimizer, copies), each with its
share; then the arch's backward kernels alone at the step's shape (flash
for danube, rwkv6_scan for rwkv6), the best of five calls by CUDA events
(``utils.timing.bench``).

    python3 scripts/train_profile.py [--arch h2o-danube-1.8b] [--layers N] [--batch 4] [--seq 4096]

Run from the root of a checkout on a machine with CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (("rwkv6_scan backward", ("rwkv6_dstate_kernel", "rwkv6_grad_kernel",
                                   "rwkv6_dstate_tc_kernel", "rwkv6_grad_tc_kernel")),
          ("rwkv6_scan forward", ("rwkv6_state_kernel", "rwkv6_chunk_out_kernel",
                                  "rwkv6_scan_kernel", "rwkv6_decode_kernel")),
          ("flash backward", ("rowdot_kernel", "dkdv_kernel", "dq_kernel", "dkdv_tc_kernel",
                             "dq_tc_kernel")),
          ("flash forward", ("flash_tc_kernel", "flash_kernel")),
          ("matrix products", ("gemm", "nvjet", "cutlass", "sm90_xmma", "Kernel2")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "the rest"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=None, help="keep the first N layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.config import ShapeConfig, TrainConfig, get_arch
    from repro_torch.kernels.flashattn import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import _launch, rwkv6_scan_bwd
    from repro_torch.models import build_model
    from repro_torch.train.data import pipeline_for
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.utils.timing import bench

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    tcfg = TrainConfig(total_steps=5, warmup_steps=1)
    model = build_model(cfg, dev)
    state = init_train_state(model, tcfg, 0)
    step = make_train_step(model, tcfg)
    source = pipeline_for(cfg, ShapeConfig("p", args.seq, args.batch, "train")).source
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(i).items()}
               for i in range(3)]
    for b in batches[:2]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        state, m = step(state, batches[2])
        float(m["loss"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    from torch.autograd import DeviceType

    groups: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:     # the kernels only, not the ops that launch them
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            g = groups.setdefault(group_of(ev.key), [0.0, 0])
            g[0] += us / 1e3
            g[1] += ev.count
    busy = sum(ms for ms, _ in groups.values())
    print(f"{cfg.name} ({cfg.num_layers} layers) train step B {args.batch} S {args.seq}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%)", flush=True)
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.1f} ms in {n} kernels ({100 * ms / busy:.1f}% of busy)", flush=True)
    del state, step, model, batches
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(0)
    if cfg.family == "rwkv6":
        B, S, K = args.batch, args.seq, cfg.ssm_head_dim
        H = cfg.d_model // K
        r, k, v, dout = (torch.randn((B, H, S, K), generator=g, device=dev).mul(0.5)
                         .to(torch.bfloat16) for _ in range(4))
        logw = -torch.exp(torch.rand((B, H, S, K), generator=g, device=dev) * 2 - 6)
        u, s0 = torch.randn((H, K), device=dev), torch.zeros((B, H, K, K), device=dev)
        _, _, states = _launch(r, k, v, logw, u, s0, 64, keep_states=True)
        best = bench(lambda: rwkv6_scan_bwd(r, k, v, logw, u, states, dout, torch.zeros_like(s0)),
                     cuda_events=True)
        print(f"rwkv6_scan backward alone at B {B} H {H} S {S} K {K}: {1e3 * best:.3f} ms a "
              f"layer (best of 5, CUDA events)", flush=True)
        return 0
    if cfg.family != "dense":
        return 0
    B, H, KV, S, hd, W = args.batch, cfg.num_heads, cfg.num_kv_heads, args.seq, cfg.head_dim, \
        cfg.sliding_window
    q, k, v, dout = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                     for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))
    out, lse = flash_attention_fwd(q, k, v, causal=True, window=W)
    best = bench(lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=W),
                 cuda_events=True)
    print(f"flash backward alone at B {B} H {H}/{KV} S {S} hd {hd} W {W}: "
          f"{1e3 * best:.3f} ms a layer (best of 5, CUDA events)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
