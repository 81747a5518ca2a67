"""Quantized fixed-point serving path (paper C4/C5; counterpart of
``repro.models.quantized``).

``quantize_params`` replaces a model's matmul weights with int8 codes and
per-output-channel f32 scale vectors, ``{"q": (K, N) int8, "s": (N,) f32}``;
``qlinear`` sends such a leaf through ``quantized_matmul`` and the
fixmatmul kernel, and a float weight through a plain matmul.  Under a
``DeviceMesh`` (DTensor activations) the int8 product runs on each rank's
shard of the weight (``sharding.local.quantized_matmul``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.fixmatmul.ops import quantized_matmul
from repro_torch.sharding import local
from repro_torch.utils.tree import tree_flatten_with_names, tree_map_with_names

# Parameter-name suffixes that are 2-D GEMM weights worth quantizing.
_QUANT_SUFFIXES = (
    "attn/wq", "attn/wk", "attn/wv", "attn/wo",
    "mlp/w1", "mlp/w2", "mlp/w3",
    "lm_head",
)


def quantizable(name: str, x) -> bool:
    # 2-D weights, or 3-D layer-stacked (L, in, out) ones.
    return any(name.endswith(s) for s in _QUANT_SUFFIXES) and x.ndim in (2, 3)


def _quant_leaf(w: torch.Tensor) -> dict:
    """Per-output-channel int8 over the last axis (leading dims kept)."""
    w = w.to(torch.float32)
    absmax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(-2).to(torch.float32)}


def quantize_params(params: Any) -> Any:
    """Replace quantizable leaves with ``{"q": int8, "s": f32}`` dicts."""
    return tree_map_with_names(lambda name, x: _quant_leaf(x) if quantizable(name, x) else x,
                               params)


def qlinear(x: torch.Tensor, w) -> torch.Tensor:
    """Linear through the int8 fixmatmul kernel if ``w`` is quantized,
    else a plain matmul."""
    if isinstance(w, dict) and "q" in w:
        if isinstance(x, DTensor):
            return local.quantized_matmul(x, w["q"], w["s"], x.dtype)
        return quantized_matmul(x, w["q"], w["s"], out_dtype=x.dtype)
    return x @ w


def quantization_error(params, qparams) -> dict[str, float]:
    """Per-leaf relative dequantization error (diagnostics)."""
    qflat = dict(tree_flatten_with_names(qparams))
    out = {}
    for name, w in tree_flatten_with_names(params):
        if name + "/q" in qflat:
            s = qflat[name + "/s"]
            back = qflat[name + "/q"].to(torch.float32) * s[..., None, :]
            w32 = w.to(torch.float32)
            denom = float(torch.max(torch.abs(w32)) + 1e-9)
            out[name] = float(torch.max(torch.abs(back - w32))) / denom
    return out
