"""The CUDA kernels have no backward pass yet: refuse inputs that ask for one.

A kernel's output is allocated fresh, so without this check ``backward()``
would treat it as a constant and raise nothing.  The plain versions, which
the CPU takes, stay differentiable.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and a floating tensor among ``tensors``
    requires grad; call it before a kernel launches."""
    if torch.is_grad_enabled() and any(t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass, and an input requires grad.  "
            "Call it under torch.no_grad(), or on CPU tensors, whose plain version is "
            "differentiable; its backward kernel comes with the training slice "
            "(ROADMAP.md queue 1, item 9).")
