"""Replica voting — the paper's ensemble-VM majority decision (resilience 4)
applied to multi-pod training (counterpart of ``repro.resilience.voting``).

Each pod computes a cheap digest of its slice (loss, grad-norm, a param
checksum).  Digests are compared host-side each slice: a disagreeing pod
indicates silent data corruption (paper §2.6 "data processing errors") and
is flagged; policy hooks decide whether to drop its contribution, re-run the
slice, or re-broadcast state (heal) — mirroring EnsembleVM.vote/heal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def majority(keys: list) -> tuple[object, list[int]]:
    """The most common of ``keys`` (the first to reach the top count on a
    tie) and the indices of the keys that differ from it."""
    counts: dict = {}
    for k in keys:
        counts[k] = counts.get(k, 0) + 1
    top = max(counts.items(), key=lambda kv: kv[1])[0]
    return top, [i for i, k in enumerate(keys) if k != top]


@dataclass
class VoteRecord:
    step: int
    digests: list[tuple]
    agree: bool
    faulty: list[int]


@dataclass
class ReplicaVoter:
    n_replicas: int
    history: list[VoteRecord] = field(default_factory=list)

    def digest(self, loss: float, grad_norm: float, checksum: float) -> tuple:
        return (
            np.float32(loss).tobytes(),
            np.float32(grad_norm).tobytes(),
            np.float32(checksum).tobytes(),
        )

    def vote(self, step: int, digests: list[tuple]) -> VoteRecord:
        assert len(digests) == self.n_replicas
        _, faulty = majority(digests)
        rec = VoteRecord(step, digests, agree=not faulty, faulty=faulty)
        self.history.append(rec)
        return rec

    @property
    def fault_rate(self) -> float:
        if not self.history:
            return 0.0
        return sum(0 if r.agree else 1 for r in self.history) / len(self.history)
