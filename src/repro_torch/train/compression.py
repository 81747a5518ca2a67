"""Gradient compression (counterpart of ``repro.train.compression``) — the
paper's fixed-point scale-vector scheme (C4) applied to the data-parallel
gradient reduction: int8 symmetric quantization with one f32 scale per
block of 2048 values, quantized and dequantized in place of the reduction.

An error-feedback variant (EF21-style) keeps the quantization residual in
the optimizer loop so compression noise does not accumulate; the residual
lives with the caller.

The scale is ``absmax * f32(1/127)``: the reference divides by 127.0, and
XLA compiles that under jit (where the train step runs it) as a product
with the f32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

BLOCK = 2048
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _quant_block(g: torch.Tensor):
    """Per-block int8 quantization of a flat f32 vector."""
    n = g.shape[0]
    gp = torch.nn.functional.pad(g, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(gp), dim=1, keepdim=True) * _INV_127
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(gp / scale), -128, 127).to(torch.int8)
    return q, scale, n


def _dequant_block(q, scale, n):
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def _channel(x: torch.Tensor) -> torch.Tensor:
    q, s, n = _quant_block(x.reshape(-1))
    return _dequant_block(q, s, n).reshape(x.shape)


def compress_decompress_grads(grads):
    """Quantize+dequantize every gradient leaf (the lossy channel)."""
    return tree_map(lambda g: _channel(g.to(torch.float32)), grads)


def compress_decompress_with_feedback(grads, residual):
    """EF21-style error feedback: channel(g + e) with e updated to the
    quantization error.  Returns (decompressed, new_residual)."""
    x = tree_map(lambda g, e: g.to(torch.float32) + e, grads, residual)
    y = tree_map(_channel, x)
    return y, tree_map(lambda a, b: a - b, x, y)


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
