"""lutact — the interpolated fixed-point sigmoid (paper §4.2, C5).

  lutact.py — build (nvcc, sm_90a), ctypes binding and launch wrapper
              ``lut_sigmoid`` (CUDA tensors -> kernel; CPU -> plain version);
  ops.py    — ``fixed_sigmoid``, the public op, any shape;
  ref.py    — the plain version ``lut_sigmoid_ref``;
  csrc/     — ``lutact.cu``, the kernel, over ``lutact_core.h``, its
              per-element body (also built with g++ by the CPU tests).
"""

from repro_torch.kernels.lutact.lutact import lut_sigmoid
from repro_torch.kernels.lutact.ops import fixed_sigmoid
from repro_torch.kernels.lutact.ref import lut_sigmoid_ref

__all__ = ["fixed_sigmoid", "lut_sigmoid", "lut_sigmoid_ref"]
