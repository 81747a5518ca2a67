"""Training launcher CLI (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 5 --batch 4 --seq 4096

Runs the Trainer (slices, checkpoint/restore, voting) on CUDA (and raises
without it; ``main(argv, device="cpu")`` runs on the CPU).  Weights are
random, drawn on the device from ``--seed``; the data is the synthetic
pipeline's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.config import RunConfig, ShapeConfig, TrainConfig, get_arch, get_smoke
from repro_torch.models import build_model
from repro_torch.resilience.checkpoint import CheckpointManager
from repro_torch.resilience.voting import ReplicaVoter
from repro_torch.train.data import pipeline_for
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer


def main(argv=None, device=None) -> int:
    """``device`` is for callers in Python (tests pass "cpu")."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--slice-steps", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model_cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    train_cfg = TrainConfig(
        lr=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        optimizer=args.optimizer,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        slice_steps=args.slice_steps,
        seed=args.seed,
    )
    run = RunConfig(model=model_cfg, shape=shape, train=train_cfg)

    model = build_model(model_cfg, device)
    print(f"[train] {model_cfg.name}: {model_cfg.param_count():,} params, "
          f"batch {args.batch} x seq {args.seq} on {model.device}")
    state = init_train_state(model, train_cfg, args.seed)
    step_fn = make_train_step(model, train_cfg)
    pipeline = pipeline_for(model_cfg, shape, seed=args.seed)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(
        run, step_fn, state, pipeline, ckpt=ckpt,
        voter=ReplicaVoter(n_replicas=1),
        put_batch=lambda b: {k: torch.from_numpy(v).to(model.device) for k, v in b.items()},
    )
    if args.resume and trainer.restore():
        print(f"[train] resumed at step {trainer.current_step()}")

    while trainer.current_step() < args.steps:
        m = trainer.run_slice(min(train_cfg.slice_steps, args.steps - trainer.current_step()))
        print(
            f"[train] step {trainer.current_step():5d} "
            f"loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}"
        )
        if ckpt and trainer.current_step() % (
            train_cfg.slice_steps * train_cfg.ckpt_every_slices
        ) == 0:
            trainer.save()
    trainer.save()
    pipeline.close()
    print(f"[train] done at step {trainer.current_step()}; "
          f"loss {trainer.log.losses[0]:.3f} -> {trainer.log.losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
