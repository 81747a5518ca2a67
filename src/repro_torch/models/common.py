"""Shared model building blocks (counterpart of ``repro.models.common``).

Parameters are plain nested dicts of tensors; a layer stack is a list of
per-layer dicts (the reference stacks them on a leading axis for
``lax.scan``; here a Python loop walks the list).  Every random draw comes
from an explicit ``torch.Generator``: the same distributions as the
reference's ``jax.random`` inits, not the same bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.api import logical

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# -- initializers ----------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, scale: float = 0.02) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def fanin_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """N(0, 1/fan_in) with fan_in = the second-to-last dim."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(gen, shape, dtype, scale=1.0 / np.sqrt(fan_in))


# -- primitive ops -----------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return ((x32 * rms) * w.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def act_fn(name: str) -> Callable:
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    if name == "silu":
        return F.silu
    if name in ("gelu", "gelu_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(name)


def mlp_swiglu(x, w1, w3, w2, act, use_bias=False, b1=None, b3=None, b2=None):
    """Gated MLP: act(x@w1) * (x@w3) @ w2 (llama-style)."""
    h = x @ w1
    g = x @ w3
    if use_bias:
        h = h + b1
        g = g + b3
    h = act(h) * g
    h = logical(h, "batch", "seq", "ff")
    o = h @ w2
    if use_bias:
        o = o + b2
    return o


def mlp_plain(x, w1, w2, act, use_bias=False, b1=None, b2=None):
    """Non-gated MLP (starcoder2/whisper style)."""
    h = x @ w1
    if use_bias:
        h = h + b1
    h = act(h)
    h = logical(h, "batch", "seq", "ff")
    o = h @ w2
    if use_bias:
        o = o + b2
    return o


# -- absolute positions (whisper) ----------------------------------------------------

def sinusoidal_positions(seq_len: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position embeddings (seq_len, dim):
    built in numpy f64 into an f32 table, then cast, as the reference does."""
    pos = np.arange(seq_len)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    pe = np.zeros((seq_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def sinusoidal_at(pos: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The sinusoidal row (dim,) at position ``pos`` (a Python int), computed
    on ``device`` in f32 as the reference computes its decode row."""
    log_base = float(np.log(np.float32(10000.0)))            # f32, as jnp.log(10000.0)
    div = torch.exp(-log_base * torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    ang = float(pos) * div
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(dim)
    return pe.to(dtype)
