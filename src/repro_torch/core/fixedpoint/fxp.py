"""Scale-vector fixed-point arithmetic (paper §4.3.1, Tab. 5).

The paper's vector ops carry a *scale vector*: "negative scale values reduce,
positive expand the values by the scale factor" — per-element integer
multiply or divide applied after the 32-bit-accumulated op.  The PyTorch
port's copy of the integer part of ``repro.core.fixedpoint.fxp``.
"""

from __future__ import annotations

import torch


def apply_scale(v: int, s: int) -> int:
    """Scalar scale-vector semantics: s>0 expand (v*s), s<0 reduce (v/-s), 0 off."""
    if s > 0:
        return int(v) * int(s)
    if s < 0:
        # C-style truncation toward zero, as the target microcontrollers do.
        q = abs(int(v)) // (-int(s))
        return -q if v < 0 else q
    return int(v)


def apply_scale_t(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Vectorized scale-vector application over int32 tensors (the
    reference's ``apply_scale_jnp``, int32 wraparound included)."""
    v = v.to(torch.int32)
    s = s.to(torch.int32)
    expanded = v * torch.where(s > 0, s, 1)
    divisor = torch.where(s < 0, -s, 1)
    reduced = torch.sign(v) * torch.div(torch.abs(v), divisor, rounding_mode="floor")
    return torch.where(s > 0, expanded, torch.where(s < 0, reduced, v))
