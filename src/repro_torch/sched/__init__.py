"""Energy-aware real-time scheduling (counterpart of ``repro.sched``): the
paper's §6 LSA, host code, used by the Executive's spawn admission."""

from repro_torch.sched.lsa import EnergyModel, Job, LSAScheduler

__all__ = ["Job", "LSAScheduler", "EnergyModel"]
