"""Resilience (counterpart of ``repro.resilience``): replica voting and
stop-and-go checkpointing; elastic resharding comes with node sharding."""

from repro_torch.resilience.checkpoint import CheckpointManager
from repro_torch.resilience.voting import ReplicaVoter, VoteRecord, majority

__all__ = ["CheckpointManager", "ReplicaVoter", "VoteRecord", "majority"]
