"""Training driver (counterpart of ``repro.train.trainer``):
deadline-bounded slices under the LSA scheduler, with stop-and-go
checkpointing and replica voting.

  * the train loop runs in *slices* of ``slice_steps`` steps — the paper's
    micro-sliced ``vmloop`` embedded in a host service loop (Fig. 10);
  * slices and checkpoints are *jobs* with (priority, deadline, energy)
    under the LSA scheduler (Alg. 4): deadline-critical work (checkpoints)
    preempts greedy compute;
  * a slice that overruns its deadline is cut short; progress already made
    is kept;
  * per-slice digests feed the ReplicaVoter (SDC detection across pods);
  * checkpoints are atomic, versioned and resumable.

The device is synchronized (``torch.cuda.synchronize``) where the
reference blocks until its arrays are ready.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.config import RunConfig
from repro_torch.resilience.checkpoint import CheckpointManager
from repro_torch.resilience.voting import ReplicaVoter
from repro_torch.sched.lsa import EnergyModel, Job, LSAScheduler
from repro_torch.train.data import DataPipeline
from repro_torch.utils.tree import tree_leaves


@dataclass
class TrainLog:
    steps: list[int] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    slice_times: list[float] = field(default_factory=list)
    ckpt_steps: list[int] = field(default_factory=list)
    preempted_slices: int = 0


def _block(t: torch.Tensor) -> None:
    """Wait for the device that holds ``t``."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class Trainer:
    """Single-process trainer (multi-host launch wires one per host)."""

    def __init__(
        self,
        run: RunConfig,
        train_step: Callable,      # (state, batch) -> (state, metrics)
        state: Any,
        pipeline: DataPipeline,
        ckpt: Optional[CheckpointManager] = None,
        voter: Optional[ReplicaVoter] = None,
        put_batch: Callable = lambda b: b,
    ):
        self.run = run
        self.train_step = train_step
        self.state = state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.voter = voter
        self.put_batch = put_batch
        self.log = TrainLog()
        self._profile_step_s: Optional[float] = None   # paper §6.2 profiling

    # -- slices ------------------------------------------------------------------

    def current_step(self) -> int:
        return int(self.state.step)

    def run_slice(self, max_steps: int, deadline_s: float = 0.0) -> dict:
        """Run up to ``max_steps`` steps; cut at the wall deadline (watchdog,
        Alg. 1's `longest`).  Returns the last metrics as floats."""
        t0 = time.perf_counter()
        metrics = {}
        done = 0
        for _ in range(max_steps):
            batch = self.put_batch(self.pipeline.next_batch())
            self.state, metrics = self.train_step(self.state, batch)
            done += 1
            if deadline_s > 0:
                _block(metrics["loss"])
                if time.perf_counter() - t0 > deadline_s:
                    self.log.preempted_slices += 1
                    break
        _block(tree_leaves(self.state.params)[0])
        dt = time.perf_counter() - t0
        if done:
            self._profile_step_s = dt / done
        metrics = {k: float(v) for k, v in metrics.items()}
        step = self.current_step()
        self.log.steps.append(step)
        self.log.losses.append(metrics.get("loss", float("nan")))
        self.log.slice_times.append(dt)
        if self.voter is not None:
            digest = self.voter.digest(
                metrics.get("loss", 0.0),
                metrics.get("grad_norm", 0.0),
                self._param_checksum(),
            )
            # Single-process stand-in: every replica sees the same digest.
            self.voter.vote(step, [digest] * self.voter.n_replicas)
        return metrics

    def _param_checksum(self) -> float:
        leaf = tree_leaves(self.state.params)[0]
        return float(torch.sum(leaf.detach().to(torch.float32)))

    # -- checkpointing -------------------------------------------------------------

    def save(self) -> None:
        if self.ckpt is None:
            return
        step = self.current_step()
        self.ckpt.save(step, self.state, extra={"data": self.pipeline.state_dict()})
        self.log.ckpt_steps.append(step)

    def restore(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        self.state, extra = self.ckpt.restore(self.state)
        self.pipeline.load_state_dict(extra["data"])
        return True

    # -- LSA-scheduled run (paper Alg. 4 driving the pod) -----------------------------

    def train_lsa(
        self,
        total_steps: int,
        *,
        budget_capacity: float = 1e9,
        budget_rate: float = 0.0,
        eval_fn: Optional[Callable] = None,
    ) -> TrainLog:
        cfg = self.run.train
        sched = LSAScheduler(EnergyModel(budget_capacity, budget_capacity, budget_rate))
        slice_s = self._profile_step_s or 1.0

        def make_slice_job(deadline):
            return Job(
                name="train_slice",
                priority=1,
                deadline=deadline,
                e_cost=cfg.slice_steps,
                duration=cfg.slice_steps * slice_s,
                fn=lambda: self.run_slice(cfg.slice_steps, cfg.slice_deadline_s),
            )

        n_slices = (total_steps + cfg.slice_steps - 1) // cfg.slice_steps
        for i in range(n_slices):
            sched.add(make_slice_job(deadline=(i + 1) * cfg.slice_steps * slice_s * 4))
            if (i + 1) % cfg.ckpt_every_slices == 0:
                sched.add(Job(
                    name="checkpoint",
                    priority=10,                      # deadline-critical
                    deadline=(i + 1) * cfg.slice_steps * slice_s * 4 + 1,
                    e_cost=1,
                    duration=0.5,
                    fn=self.save,
                ))
        if eval_fn is not None:
            sched.add(Job(
                name="eval", priority=5,
                deadline=n_slices * cfg.slice_steps * slice_s * 4,
                e_cost=cfg.slice_steps // 2, duration=1.0, fn=eval_fn,
            ))
        sched.run_until(n_slices * cfg.slice_steps * slice_s * 100,
                        max_steps=n_slices * 10 + 100)
        self.save()
        return self.log
