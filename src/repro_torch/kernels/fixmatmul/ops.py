"""Public fixmatmul op: a quantized linear layer y = q(x) @ q(w) with the
paper's scale-vector dequantization (counterpart of the JAX package's
``kernels/fixmatmul/ops.py``).  The per-row activation quantization is
plain PyTorch, as the JAX package computes it outside its kernel; the
kernel masks ragged shapes itself, so nothing is padded."""

from __future__ import annotations

import torch

from repro_torch.core.fixedpoint.fxp import quantize_per_channel
from repro_torch.kernels.fixmatmul.fixmatmul import fixmatmul


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of x (M, K): (int8 (M, K), f32 scales (M,))."""
    xq, sx = quantize_per_channel(x, bits=8, axis=0)
    return xq, sx.reshape(-1)


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, *,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dynamic per-row activation quantization + int8 GEMM + dequant.
    ``x`` (..., K) float, ``wq`` (K, N) int8, ``sw`` (N,) f32."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = wq.shape[1]
    xq, sx = quantize_rows(x.reshape(-1, K))
    out = fixmatmul(xq, wq, sx, sw.reshape(-1))
    return out.reshape(*lead, N).to(out_dtype)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (int8 (K, N), f32 (N,)) per output channel."""
    q, s = quantize_per_channel(w, bits=8, axis=1)
    return q, s.reshape(-1)
