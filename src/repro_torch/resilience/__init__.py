"""Resilience (counterpart of ``repro.resilience``): replica voting so far;
checkpointing comes with the Executive and elastic resharding with node
sharding."""

from repro_torch.resilience.voting import ReplicaVoter, VoteRecord, majority

__all__ = ["ReplicaVoter", "VoteRecord", "majority"]
