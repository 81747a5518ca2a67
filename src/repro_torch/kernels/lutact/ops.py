"""Public lutact op (counterpart of the JAX package's
``kernels/lutact/ops.py``).  The JAX op pads to 256-blocks for the TPU's
tiling; the kernel here walks the flat tensor and masks its own tail, so
nothing is padded."""

from __future__ import annotations

import torch

from repro_torch.kernels.lutact.lutact import lut_sigmoid


def fixed_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Fixed-point sigmoid over an int32 tensor of any shape (scale 1:1000)."""
    return lut_sigmoid(x.to(torch.int32))
