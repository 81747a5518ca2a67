"""Serving launcher CLI (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 4 --prompt-len 16 --new-tokens 16

Runs on CUDA (and raises without it).  Weights are random, drawn on the
card from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import ServeConfig, get_arch, get_smoke
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None, device=None) -> int:
    """``device`` is for callers in Python (tests pass "cpu")."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    model = build_model(cfg, device)
    params = model.init(args.seed)
    engine = ServeEngine(
        model, params,
        ServeConfig(temperature=args.temperature),
        max_len=args.prompt_len + args.new_tokens + 8,
    )
    rng = np.random.default_rng(args.seed)
    prompts = [
        rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()
        for _ in range(args.batch)
    ]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.new_tokens,
                           generator=torch.Generator().manual_seed(args.seed))
    dt = time.perf_counter() - t0
    print(f"[serve] {engine.stats.decode_tokens} new tokens in {dt:.2f}s "
          f"({engine.stats.decode_tokens / dt:.1f} tok/s on {model.device})")
    print("[serve] sample:", outs[0][-args.new_tokens:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
