"""Real-time monitor — round-latency histogram and wall-clock deadlines
(counterpart of ``repro.obs.deadline``).

The paper's "real-time capable" claim is a latency-distribution claim:
a fleet round must complete within a bounded, observable time.  This
module is the host half of that measurement (the *virtual-clock* half —
per-node deadline misses against the VM's own ``clock``/``us_per_instr``
time base — lives on device in ``ObsCounters.deadline_miss``, where it is
deterministic and byte-exact across executors).

:class:`DeadlineMonitor` keeps a fixed log-spaced latency histogram
(25 bucket edges over 10µs..10s, one overflow bucket) fed with one
wall-clock sample per fleet round.  Fixed buckets keep ``record`` O(1)
and the snapshot schema stable regardless of how many rounds ran;
percentiles are read back from the histogram (upper-edge conservative,
like Prometheus).  An optional wall-clock deadline counts rounds whose
latency exceeded ``deadline_wall_ms``.
"""

from __future__ import annotations

import numpy as np

# Bucket upper edges in ms: 1e-2 .. 1e4 (10µs .. 10s), 4 buckets per decade.
BUCKETS_MS = np.logspace(-2, 4, 25)


class DeadlineMonitor:
    """Per-round wall-clock latency histogram + deadline-miss counter."""

    def __init__(self, deadline_wall_ms: float = 0.0):
        self.deadline_wall_ms = float(deadline_wall_ms)
        self.counts = np.zeros(len(BUCKETS_MS) + 1, dtype=np.int64)
        self.rounds_timed = 0
        self.misses = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def record(self, dt_ms: float):
        """Record one round's wall latency in milliseconds."""
        self.counts[np.searchsorted(BUCKETS_MS, dt_ms)] += 1
        self.rounds_timed += 1
        self.sum_ms += dt_ms
        if dt_ms > self.max_ms:
            self.max_ms = dt_ms
        if self.deadline_wall_ms > 0 and dt_ms > self.deadline_wall_ms:
            self.misses += 1

    def percentile(self, q: float) -> float:
        """Latency percentile from the histogram (conservative: returns the
        upper edge of the bucket containing the q-th sample, capped at the
        exactly-tracked maximum so p50 can never exceed max_ms)."""
        if self.rounds_timed == 0:
            return 0.0
        rank = q / 100.0 * self.rounds_timed
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, max(rank, 1)))
        if idx >= len(BUCKETS_MS):
            return float(self.max_ms)
        return float(min(BUCKETS_MS[idx], self.max_ms))

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.rounds_timed if self.rounds_timed else 0.0

    def snapshot(self) -> dict:
        """Schema-stable dict (same keys whether or not any round was
        timed) — the ``latency`` section of ``FleetVM.metrics()``."""
        return {
            "buckets_ms": [float(b) for b in BUCKETS_MS],
            "counts": [int(c) for c in self.counts],
            "rounds_timed": int(self.rounds_timed),
            "mean_ms": float(self.mean_ms),
            "max_ms": float(self.max_ms),
            "p50_ms": self.percentile(50.0),
            "p99_ms": self.percentile(99.0),
            "deadline_wall_ms": float(self.deadline_wall_ms),
            "deadline_misses": int(self.misses),
        }
