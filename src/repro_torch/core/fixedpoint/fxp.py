"""Scale-vector fixed-point arithmetic (paper §4.3.1, Tab. 5).

The paper's vector ops carry a *scale vector*: "negative scale values reduce,
positive expand the values by the scale factor" — per-element integer
multiply or divide applied after the 32-bit-accumulated op, and its
per-channel generalization used by the fixmatmul serving path.  The
PyTorch port's copy of ``repro.core.fixedpoint.fxp``.
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


# ---------------------------------------------------------------------------
# Per-channel quantization for the fixmatmul serving path.
# ---------------------------------------------------------------------------

def quantize_per_channel(w: torch.Tensor, bits: int = 8, axis: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel quantization (the reference's
    ``quantize_per_channel``): ``(q, scale)`` with ``w ~= q * scale``, ``q``
    int8 (int16 above 8 bits) and ``scale`` f32, kept with size 1 on every
    axis but ``axis``.  Rounds half to even, as ``jnp.round`` does."""
    w = w.to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    absmax = torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True)
    scale = torch.clamp(absmax / qmax, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int16), scale
