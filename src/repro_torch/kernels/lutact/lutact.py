"""The lut_sigmoid CUDA kernel: build, bind and launch.

Replaces the TPU kernel ``lut_sigmoid`` of the JAX package
(``src/repro/kernels/lutact/lutact.py``, ``pl.pallas_call``).  The source
is ``csrc/lutact.cu`` over ``csrc/lutact_core.h`` (see the note at its top
for what bounds it), built by ``LIBRARY`` (``kernels/nvcc.py``) with nvcc
for sm_90a at first use and loaded with ``ctypes``.

A CUDA tensor launches the kernel, and a failed build or launch raises;
only CPU tensors take the plain version (``ref.lut_sigmoid_ref``).
``lut_sigmoid.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.fixedpoint.luts import lut
from repro_torch.kernels.lutact.ref import lut_sigmoid_ref
from repro_torch.kernels.nvcc import CudaLibrary, check_launch, sm_count

CSRC = Path(__file__).resolve().parent / "csrc"
BLOCKS_PER_SM = 8                # grid-stride loop: at most this many blocks per SM


def _bind(lib) -> None:
    fn = lib.lut_sigmoid_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("lutact", CSRC, "lutact.cu", ("lutact_core.h",), _bind)


def lut_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The interpolated int32 sigmoid at scale 1:1000, elementwise over an
    int32 tensor of any shape.  CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    if x.dtype != torch.int32:
        raise ValueError(f"lut_sigmoid: x must be int32, got {x.dtype}")
    dev = x.device
    if dev.type == "cpu":
        return lut_sigmoid_ref(x)
    if dev.type != "cuda":
        raise ValueError(f"lut_sigmoid: unsupported device {dev}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = LIBRARY.load()
    err = lib.lut_sigmoid_launch(x.data_ptr(), out.data_ptr(), lut("sig_interp", dev).data_ptr(),
                                 x.numel(), BLOCKS_PER_SM * sm_count(dev),
                                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "lut_sigmoid")
    lut_sigmoid.launches += 1
    return out


lut_sigmoid.launches = 0
