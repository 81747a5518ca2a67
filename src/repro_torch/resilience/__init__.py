"""Resilience (counterpart of ``repro.resilience``): replica voting,
stop-and-go checkpointing and elastic resharding onto another node mesh."""

from repro_torch.resilience.checkpoint import CheckpointManager
from repro_torch.resilience.elastic import reshard_state
from repro_torch.resilience.voting import ReplicaVoter, VoteRecord, majority

__all__ = ["CheckpointManager", "ReplicaVoter", "VoteRecord", "majority", "reshard_state"]
