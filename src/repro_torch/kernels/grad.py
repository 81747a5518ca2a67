"""Refuse inputs that ask for a backward pass at a CUDA kernel that has none.

A kernel's output is allocated fresh, so without this check ``backward()``
would treat it as a constant and raise nothing.  The plain versions, which
the CPU takes, stay differentiable.  Flash attention's and rwkv6_scan's
backwards are kernels of their own: the training path reaches them
through ``flashattn.ops.attention`` and ``rwkv6_scan.ops.wkv`` (the
``FlashAttention`` and ``RwkvScan`` autograd functions), while the raw
``flash_attention`` and ``rwkv6_scan`` still refuse.  Only fixmatmul (the
int8 serve path) has no backward.
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
            "differentiable; flash attention trains through flashattn.ops.attention and "
            "rwkv6_scan through rwkv6_scan.ops.wkv, and fixmatmul has no backward.")
