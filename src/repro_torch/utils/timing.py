"""Wall-clock timing helpers for benchmarks and the trainer (counterpart
of ``repro.utils.timing``).  ``bench`` synchronizes the device on both
sides of each call, where the reference blocks until its outputs are
ready; with ``cuda_events=True`` it times the calls on the card with CUDA
events instead of the host clock."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Timer:
    """Accumulating timer with per-lap statistics."""

    laps: list[float] = field(default_factory=list)
    _t0: float | None = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        assert self._t0 is not None, "Timer.stop() before start()"
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        self._t0 = None
        return dt

    @property
    def total(self) -> float:
        return sum(self.laps)

    @property
    def mean(self) -> float:
        return self.total / len(self.laps) if self.laps else 0.0

    @property
    def best(self) -> float:
        return min(self.laps) if self.laps else 0.0


@contextlib.contextmanager
def timed(timer: Timer):
    timer.start()
    try:
        yield timer
    finally:
        timer.stop()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def bench(fn, *args, warmup: int = 2, iters: int = 5, cuda_events: bool = False) -> float:
    """Best-of-``iters`` seconds for ``fn(*args)``.  By the host clock with
    the device synchronized around each call; with ``cuda_events`` by a
    pair of CUDA events around each call on the current stream (the card's
    time, which needs a CUDA device)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    if not cuda_events:
        t = Timer()
        for _ in range(iters):
            t.start()
            fn(*args)
            _sync()
            t.stop()
        return t.best
    laps = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        laps.append(start.elapsed_time(end) / 1e3)
    return min(laps)
