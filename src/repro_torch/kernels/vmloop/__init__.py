"""vmloop — the fleet's per-node interpreter loop as a CUDA kernel.

  vmloop.py — build (nvcc, sm_90a), ctypes binding and launch wrapper
              ``vmloop_call`` (CUDA tensors -> kernel; CPU -> plain version);
  ops.py    — ``fleet_vmloop``: stacked-VMState wrapper;
  ref.py    — the contract: ``CoreState``, ``Tables``, the opcode claim and
              the plain version ``run_core``/``vmloop_ref``;
  csrc/     — ``vmloop_core.h`` (op bodies, written once for nvcc and g++),
              ``vmloop.cu`` (the kernel), ``vmloop_host.cpp`` (CPU build of
              the same header, used by the tests only).
"""

from repro_torch.kernels.vmloop.ops import fleet_vmloop
from repro_torch.kernels.vmloop.ref import (
    BAILOUT_WORDS,
    SUPPORTED_WORDS,
    CoreState,
    supported_mask,
    vmloop_ref,
)
from repro_torch.kernels.vmloop.vmloop import vmloop_call

__all__ = [
    "fleet_vmloop", "vmloop_call", "vmloop_ref", "CoreState",
    "SUPPORTED_WORDS", "BAILOUT_WORDS", "supported_mask",
]
