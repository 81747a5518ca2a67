"""The plain version of lut_sigmoid (counterpart of the JAX package's
``kernels/lutact/ref.py``): the interpolated fixed-point sigmoid
``fpsigmoid_interp_t``, the torch form of ``fpsigmoid_interp_jnp``."""

from __future__ import annotations

import torch

from repro_torch.core.fixedpoint.luts import fpsigmoid_interp_t


def lut_sigmoid_ref(x: torch.Tensor) -> torch.Tensor:
    return fpsigmoid_interp_t(x)
