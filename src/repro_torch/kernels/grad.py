"""Refuse inputs that ask for a backward pass at a CUDA kernel that has none.

A kernel's output is allocated fresh, so without this check ``backward()``
would treat it as a constant and raise nothing.  The plain versions, which
the CPU takes, stay differentiable.  Flash attention's backward is a
kernel of its own: the training path reaches it through ``ops.attention``
(the ``FlashAttention`` autograd function), while the raw
``flash_attention`` still refuses.  fixmatmul (the int8 serve path) and
rwkv6_scan have none yet.
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
            "differentiable; flash attention trains through ops.attention, and rwkv6_scan's "
            "backward kernel is still to come (ROADMAP.md queue 1).")
