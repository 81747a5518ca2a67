"""Attention: GQA + RoPE, optional sliding window, blocked (flash-style)
softmax for full sequences, and single-token decode against a KV cache
(counterpart of ``repro.models.attention``).  Nothing here copies a host
value to the device: such a copy from pageable memory waits for the
stream, which would stall every decode step.

``blocked_attention`` is the plain version of the flash attention kernel
(``kernels/flashattn/ref.py`` re-exports it); the model reaches it through
``kernels/flashattn/ops.attention``, which takes it only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding import local

NEG_INF = -1e30
# Under jit XLA turns the reference's ``absmax / 127.0`` into a product with
# the f32 reciprocal; the int8 cache's scales are that product.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd), computed in f32 as the reference does."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


# -- RoPE ------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# -- blocked causal attention (prefill) --------------------------------------------

def blocked_attention(
    q: torch.Tensor,           # (B, Sq, H, hd)
    k: torch.Tensor,           # (B, Sk, KV, hd)
    v: torch.Tensor,           # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_block: int = 1024,
    k_block: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks; GQA by head grouping.
    Scores and sums in f32; p is cast to v's dtype before it meets v, as
    in the reference.  ``q_offset`` shifts query positions."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = softmax_scale(hd)
    dev = q.device

    q_block = min(q_block, Sq)
    k_block = min(k_block, Sk)
    nq = (Sq + q_block - 1) // q_block
    nk = (Sk + k_block - 1) // k_block
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))
    q = pad(q, nq * q_block - Sq)
    k = pad(k, nk * k_block - Sk)
    v = pad(v, nk * k_block - Sk)
    qg = q.reshape(B, nq, q_block, KV, G, hd)
    kg = k.reshape(B, nk, k_block, KV, hd)
    vg = v.reshape(B, nk, k_block, KV, hd)

    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi].to(torch.float32)
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, q_block), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk, v_blk = kg[:, ki], vg[:, ki]
            k_pos = ki * k_block + torch.arange(k_block, device=dev)
            s = torch.einsum("bqngh,bknh->bngqk", q_blk, k_blk.to(torch.float32)) * scale
            mask = (k_pos < Sk)[None, :].expand(q_block, k_block)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bngqk,bknh->bngqh", p.to(v_blk.dtype).to(torch.float32),
                              v_blk.to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qb, KV, G, hd)
    out = torch.stack(outs, dim=1).reshape(B, nq * q_block, H, hd)
    return out[:, :Sq].to(q.dtype)


# -- decode attention (one new token vs a KV cache) ---------------------------------

class KVCache(NamedTuple):
    """KV cache.  ``k``/``v`` are (B, S, KV, hd), with a leading layer
    axis at the model level: float, or int8 codes (the paper's C4 cache)
    with per-(token, head) f32 dequant scales ``ks``/``vs`` (B, S, KV, 1);
    a float cache carries (1, 1, 1, 1) placeholders there, as the
    reference does.  ``pos`` is the next absolute position (= tokens
    seen).  ``decode_attention`` writes the new token into the tensors in
    place (the reference returns new arrays) and returns ``pos + 1``."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor
    pos: int

    @staticmethod
    def init(batch, length, kv_heads, head_dim, dtype, device, layers: int | None = None):
        """``dtype`` int8 gives the quantized cache."""
        lead = (layers,) if layers is not None else ()
        quant = not dtype.is_floating_point
        scale_shape = lead + ((batch, length, kv_heads, 1) if quant else (1, 1, 1, 1))
        shape = lead + (batch, length, kv_heads, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            ks=torch.ones(scale_shape, dtype=torch.float32, device=device),
            vs=torch.ones(scale_shape, dtype=torch.float32, device=device),
            pos=0,
        )

    @property
    def quantized(self) -> bool:
        return not self.k.dtype.is_floating_point

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a model-level cache (views: writes land in it)."""
        return KVCache(self.k[i], self.v[i], self.ks[i], self.vs[i], self.pos)


def _quantize_token(x: torch.Tensor):
    """x: (B, 1, KV, hd) float -> (int8, f32 scale (B, 1, KV, 1))."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(absmax * _INV_127, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -128, 127).to(torch.int8)
    return q, scale


def decode_attention(
    q: torch.Tensor,           # (B, 1, H, hd) — roped at the current position
    k_new: torch.Tensor,       # (B, 1, KV, hd) — roped at the current position
    v_new: torch.Tensor,
    cache: KVCache,
    *,
    window: Optional[int] = None,
    seq_shard=None,
) -> tuple[torch.Tensor, KVCache]:
    """Single-token attention against the cache.

    Full cache: slot = pos.  Sliding window (cache length S <= window):
    ring-buffer slot = pos % S, and only slots written within the last
    min(pos + 1, S) steps are visible.  An int8 cache stores the token's
    codes and scales, dequantizes in bf16 and contracts bf16 q and p in
    f32, as the reference does whatever the model's dtype.

    A DTensor cache (a sharded decode step) runs this function on each
    rank's (batch, KV head) shard (``sharding.local.decode_attention``):
    the slot write lands in the rank's own shard in place, which DTensor
    cannot follow through a view, and the contractions stay local.  The
    cache lies as ``cache_pspec`` placed it, the layout the reference pins
    with ``logical`` after its write (``repro/models/attention.py:203``).
    Where it shards its sequence, ``seq_shard`` is ``(lo, S, reduce)``:
    this cache holds slots ``[lo, lo + n)`` of ``S``, only the rank that
    holds the slot writes it, and ``reduce(t, op)`` all-reduces ("max",
    "sum") over the sequence shards the softmax's max and denominator and
    the output, so each shard's probabilities are the whole softmax's."""
    if isinstance(cache.k, DTensor):
        return local.decode_attention(decode_attention, q, k_new, v_new, cache, window=window)
    B, _, H, hd = q.shape
    _, n, KV, _ = cache.k.shape
    lo, S, reduce = seq_shard or (0, n, None)
    G = H // KV
    scale = softmax_scale(hd)
    pos = cache.pos
    dev = q.device
    bf16, f32 = torch.bfloat16, torch.float32

    slot = (pos % S if window is not None else pos) - lo
    write = reduce is None or 0 <= slot < n
    quant = cache.quantized
    if quant:
        for codes, scales, new in ((cache.k, cache.ks, k_new), (cache.v, cache.vs, v_new)):
            qx, sc = _quantize_token(new)
            if write:
                codes[:, slot] = qx[:, 0]
                scales[:, slot] = sc[:, 0]
        kk = (cache.k.to(bf16) * cache.ks.to(bf16)).to(f32)
        qg = q.reshape(B, KV, G, hd).to(bf16).to(f32)
    else:
        if write:
            cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
            cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        kk = cache.k.to(f32)
        qg = q.reshape(B, KV, G, hd).to(f32)

    s = torch.einsum("bngh,bsnh->bngs", qg, kk) * scale
    idx = lo + torch.arange(n, device=dev)
    if window is None:
        valid = idx <= pos
    else:
        age = torch.remainder(pos - idx, S)
        valid = age < min(pos + 1, S)
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    if reduce is None:
        p = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - reduce(s.amax(-1, keepdim=True), "max"))
        p = e / reduce(e.sum(-1, keepdim=True), "sum")
    if quant:
        vv = (cache.v.to(bf16) * cache.vs.to(bf16)).to(f32)
        p = p.to(bf16).to(f32)
    else:
        vv = cache.v.to(f32)
        p = p.to(cache.v.dtype).to(f32)
    o = torch.einsum("bngs,bsnh->bngh", p, vv)
    if reduce is not None:
        o = reduce(o, "sum")
    out = o.reshape(B, 1, H, hd).to(q.dtype)
    return out, cache._replace(pos=pos + 1)
