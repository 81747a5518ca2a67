"""Parallel VM + ensemble execution (paper §3.4 and resilience feature 4;
counterpart of ``repro.core.vm.ensemble``).

The ensemble is the degenerate fleet: N lock-stepped replicas of one
program stacked along the node axis, with majority voting over that axis
instead of message routing.  Its slice engine is the fleet's
(``FleetKernels``): the batched interpreter, or the vmloop CUDA kernel with
its interpreter hand-back.  Running the same code frame on every replica
allows majority-decision fault masking: a corrupted instance (bit-flipped
stack, code or memory — the paper's §2.6 failure taxonomy) is out-voted and
flagged, and the voted state can be re-broadcast ("stopping of faulty
computations").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.fleet import FleetKernels
from repro_torch.core.vm.vmstate import VMState, resolve_device
from repro_torch.resilience.voting import majority


@dataclass
class VoteResult:
    agree: bool
    votes: np.ndarray          # (N,) bool: instance matches majority
    faulty: list[int]          # minority instance ids


def replicate_state(st: VMState, n: int) -> VMState:
    """``n`` copies of one single state as a stacked state, on the state's
    device."""
    return VMState(*[x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone() for x in st])


class EnsembleVM:
    """N lock-stepped VM replicas with majority voting — a routing-free
    fleet.  ``executor`` is ``"batched"`` or ``"cuda"``; ``device=None``
    runs on CUDA and raises when there is none."""

    # State fields compared for the vote (the observable computation result).
    VOTE_FIELDS = ("ds", "dsp", "out", "outp", "pc", "tstatus", "mem")

    def __init__(self, cfg: VMConfig, n: int = 3, executor: str = "batched", device=None):
        if n < 1:
            raise ValueError("an ensemble needs at least one replica")
        if executor not in ("batched", "cuda"):
            raise ValueError(f"unknown ensemble executor {executor!r}: valid executors are "
                             "'batched', 'cuda'")
        self.cfg = cfg
        self.n = n
        self.device = resolve_device(device)
        self.kernels = FleetKernels(cfg, executor=executor)
        self.interp = self.kernels.interp

    def replicate(self, st: VMState) -> VMState:
        """``n`` replicas of ``st`` on the ensemble's device."""
        return replicate_state(vms.to_device(st, self.device), self.n)

    def run_slice(self, batched: VMState) -> VMState:
        """One slice of every replica, in place on the ensemble's device
        (a state elsewhere is copied there first); returns the state."""
        S = vms.to_device(batched, self.device)
        self.kernels.executor.run_slice_batched(S, self.cfg.steps_per_slice)
        return S

    def checksum(self, batched: VMState) -> np.ndarray:
        """Per-instance digest for the vote: each vote field summed as int64,
        (N, F)."""
        sums = [getattr(batched, f).reshape(self.n, -1).to(torch.int64).sum(dim=1)
                for f in self.VOTE_FIELDS]
        return torch.stack(sums, dim=1).cpu().numpy()

    def vote(self, batched: VMState) -> VoteResult:
        """Majority decision over the state digests (paper: compare
        intermediate states and results; majority decision making)."""
        _, faulty = majority([tuple(row) for row in self.checksum(batched)])
        votes = np.ones(self.n, dtype=bool)
        votes[faulty] = False
        return VoteResult(agree=not faulty, votes=votes, faulty=faulty)

    def heal(self, batched: VMState, vote: VoteResult) -> VMState:
        """A copy of ``batched`` with a majority instance re-broadcast over
        the faulty ones."""
        good = int(np.argmax(vote.votes))
        out = vms.clone(batched)
        for x in out:
            for bad in vote.faulty:
                x[bad] = x[good]
        return out
