"""Configuration of the PyTorch port: the REXA VM's ``VMConfig``.

A copy of ``repro.config.base.VMConfig`` with the same fields and defaults
(the port imports nothing of the JAX package).  Frozen, so it can key the
per-config interpreter and kernel caches.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VMConfig:
    """REXA VM configuration (paper Tab. 7 names: CS/DS/RS/FS sizes)."""

    cs_size: int = 4096               # code segment cells (bytes in paper; int32 here)
    ds_size: int = 256                # data stack depth
    rs_size: int = 128                # return stack depth
    fs_size: int = 64                 # loop stack depth
    mem_size: int = 4096              # vector/data memory cells (DIOS window)
    max_tasks: int = 8                # multi-tasking slots (Alg. 6 mask supports 16)
    steps_per_slice: int = 256        # vmloop micro-slice instruction budget
    double_words: bool = True         # 32-bit cells (paper: optional doubles)
    ensemble: int = 1                 # parallel VM instances (majority vote if >1)
    out_ring_size: int = 256          # output ring entries ([kind,value] pairs)
    max_vec: int = 64                 # vector-op window (paper ANNs <= 64/layer)
    us_per_instr: int = 10            # calibrated instr time for virtual clock
    mbox_size: int = 32               # per-node mailbox ring entries (fleet send/receive)
