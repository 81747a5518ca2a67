"""Carry parameters across from the JAX package and back.

The JAX package keeps a layer stack (``layers``, and whisper's
``enc_layers``) as leaves with a leading (L, ...) axis, except the hybrid
family's ``layers``, which it keeps a list, and a quantized weight as
``{"q": int8, "s": f32}``; the port keeps every stack as a list of
per-layer dicts with the same leaf names.  Both functions take and give
numpy arrays on the JAX side, so the port needs no JAX to use them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy's bfloat16 extension type
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 comes back as float32 (lossless): numpy has no bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _depth(key: str, cfg: ModelConfig) -> int:
    return cfg.num_layers if key == "layers" else cfg.num_encoder_layers or cfg.num_layers


_STACKS = ("layers", "enc_layers")


def params_from_jax(np_params: dict, cfg: ModelConfig, device) -> dict:
    """The JAX package's parameter tree (leaves as numpy arrays) -> the
    port's params on ``device``: each (L, ...) leaf of a stack is cut into
    per-layer leaves (``cfg.num_layers`` under ``layers``,
    ``cfg.num_encoder_layers`` under ``enc_layers``); a stack the
    reference keeps as a list is carried layer by layer."""
    out: dict[str, Any] = {}
    for key, sub in np_params.items():
        if isinstance(sub, list):
            out[key] = [_map(lambda a: _to_torch(a, device), lp) for lp in sub]
        elif key in _STACKS:
            stacked = _map(lambda a: _to_torch(a, device), sub)
            out[key] = [_map(lambda t: t[i].contiguous(), stacked)
                        for i in range(_depth(key, cfg))]
        else:
            out[key] = _map(lambda a: _to_torch(a, device), sub)
    return out


def _stack(*leaves):
    if isinstance(leaves[0], dict):
        return {k: _stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
    return np.stack(leaves)


def params_to_jax(params: dict) -> dict:
    """The inverse: the port's params -> the JAX package's tree of numpy
    arrays, per-layer leaves stacked on a leading (L, ...) axis; the
    hybrid family's ``layers`` (each with its ``mamba`` block) stay a list,
    as the reference keeps them."""
    out: dict[str, Any] = {}
    for key, sub in params.items():
        if key in _STACKS:
            per_layer = [_map(_to_numpy, lp) for lp in sub]
            out[key] = per_layer if "mamba" in sub[0] else _stack(*per_layer)
        else:
            out[key] = _map(_to_numpy, sub)
    return out
