"""The transformer blocks (counterpart of ``repro.models.transformer``):
pre-norm attention with GQA + RoPE and an optional sliding window, then a
SwiGLU or plain MLP, or the mixture of experts (``moe_sorted``); and the
decoder's cross attention over encoder K/V (whisper).  Projections go
through ``qlinear``, so int8 ``{"q", "s"}`` weights take the fixmatmul
kernel; full-sequence self attention goes through the flash attention op,
cross attention through the plain ``blocked_attention``, as in the
reference.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig
from repro_torch.kernels.flashattn.ops import attention as flash_attention_op
from repro_torch.models.attention import KVCache, apply_rope, blocked_attention, decode_attention
from repro_torch.models.common import (
    act_fn,
    fanin_init,
    layernorm,
    mlp_plain,
    mlp_swiglu,
    normal_init,
    rmsnorm,
)
from repro_torch.models.moe import moe_sorted
from repro_torch.models.quantized import qlinear
from repro_torch.sharding import local
from repro_torch.sharding.api import logical


def norm(cfg: ModelConfig, x, p, prefix: str):
    """The norm of a block's input (B, S, D).  Under sequence parallelism
    the residual stream's sequence is sharded; the normed input is
    gathered over it (Megatron's all-gather after the norm), since a
    product cannot flatten a sharded sequence dim."""
    if cfg.norm_type == "layernorm":
        out = layernorm(x, p[f"{prefix}_w"], p[f"{prefix}_b"], cfg.norm_eps)
    else:
        out = rmsnorm(x, p[f"{prefix}_w"], cfg.norm_eps)
    return logical(out, "batch", "seq", "embed")


def residual(x, y):
    """``x + y``, a block's output ``y`` added to the residual stream ``x``.
    Under sequence parallelism ``y`` is first placed as the stream is (the
    reduce-scatter after a block), so that in the backward the gradient
    reaching the block's last product is not sharded on the sequence (a
    product cannot flatten a sharded sequence dim)."""
    return x + logical(y, "batch", "act_seq", "embed")


def init_norm(cfg: ModelConfig, prefix: str, d: int, dtype, device) -> dict:
    out = {f"{prefix}_w": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        out[f"{prefix}_b"] = torch.zeros((d,), dtype=dtype, device=device)
    return out


# -- attention sub-block -------------------------------------------------------------

def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype, cross: bool = False) -> dict:
    """``cross`` is ignored: a cross-attention block has the same leaves,
    as in the reference."""
    d, dev = cfg.d_model, gen.device
    p = {
        "wq": fanin_init(gen, (d, cfg.q_dim), dtype),
        "wk": fanin_init(gen, (d, cfg.kv_dim), dtype),
        "wv": fanin_init(gen, (d, cfg.kv_dim), dtype),
        "wo": fanin_init(gen, (cfg.q_dim, d), dtype),
    }
    if cfg.use_bias or cfg.attn_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim), ("bo", d)):
            p[name] = torch.zeros((n,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["qn"] = torch.ones((cfg.head_dim,), dtype=dtype, device=dev)
        p["kn"] = torch.ones((cfg.head_dim,), dtype=dtype, device=dev)
    return p


def qkv(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    q = qlinear(x, p["wq"])
    k = qlinear(x, p["wk"])
    v = qlinear(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def attn_out(p, out):
    B, S, H, hd = out.shape
    o = qlinear(out.reshape(B, S, H * hd), p["wo"])
    if "bo" in p:
        o = o + p["bo"]
    return o


def self_attention_full(p, cfg: ModelConfig, x, *, causal=True, use_rope=True, window=None,
                        attention=None):
    """Full-sequence self attention (prefill).  ``attention`` (BSHD q, k, v
    -> out) defaults to the flash attention op; a check passes the plain
    version to hold the kernel's path against it."""
    B, S, _ = x.shape
    q, k, v = qkv(p, cfg, x)
    if use_rope:
        pos = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q = logical(q, "batch", "seq", "heads", None)
    k = logical(k, "batch", "seq", "kv_heads", None)
    op = attention or flash_attention_op
    if isinstance(q, DTensor):      # the kernel takes each rank's (batch, head) shard
        out = local.attention(op, q, k, v, causal=causal, window=window)
    else:
        out = op(q, k, v, causal=causal, window=window)
    out = logical(out, "batch", "seq", "heads", None)
    return attn_out(p, out)


def self_attention_decode(p, cfg: ModelConfig, x, cache: KVCache, *, use_rope=True,
                          window=None):
    """One-token self attention against the KV cache."""
    q, k, v = qkv(p, cfg, x)
    if use_rope:
        pos = torch.full((1, 1), cache.pos, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out, cache = decode_attention(q, k, v, cache, window=window)
    return attn_out(p, out), cache


def cross_attention(p, cfg: ModelConfig, x, enc_k, enc_v):
    """Decoder cross attention over precomputed encoder K/V (B, T, KV, hd):
    plain attention, no mask, one query block and one key block."""
    B, S, _ = x.shape
    q = qlinear(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    kw = dict(causal=False, q_block=min(1024, S), k_block=enc_k.shape[1])
    if isinstance(q, DTensor):      # per (batch, head) shard, as self attention
        out = local.attention(blocked_attention, q, enc_k, enc_v, **kw)
    else:
        out = blocked_attention(q, enc_k, enc_v, **kw)
    return attn_out(p, out)


# -- MLP and the layer ------------------------------------------------------------------

def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype, d_ff=None) -> dict:
    d, f, dev = cfg.d_model, d_ff or cfg.d_ff, gen.device
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)
    if cfg.mlp_gated:
        p = {
            "w1": fanin_init(gen, (d, f), dtype),
            "w3": fanin_init(gen, (d, f), dtype),
            "w2": fanin_init(gen, (f, d), dtype),
        }
        if cfg.use_bias:
            p |= {"b1": zeros(f), "b3": zeros(f), "b2": zeros(d)}
    else:
        p = {"w1": fanin_init(gen, (d, f), dtype), "w2": fanin_init(gen, (f, d), dtype)}
        if cfg.use_bias:
            p |= {"b1": zeros(f), "b2": zeros(d)}
    return p


def apply_mlp(p, cfg: ModelConfig, x):
    act = act_fn(cfg.activation)
    if isinstance(p["w1"], dict):   # int8 serving path (paper C4)
        h = act(qlinear(x, p["w1"]))
        if cfg.mlp_gated:
            h = h * qlinear(x, p["w3"])
        h = logical(h, "batch", "seq", "ff")
        return qlinear(h, p["w2"])
    if cfg.mlp_gated:
        return mlp_swiglu(x, p["w1"], p["w3"], p["w2"], act, cfg.use_bias,
                          p.get("b1"), p.get("b3"), p.get("b2"))
    return mlp_plain(x, p["w1"], p["w2"], act, cfg.use_bias, p.get("b1"), p.get("b2"))


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    ep = cfg.num_expert_slots          # padded slots (e.g. 60 -> 64), never routed
    p = {
        "router": normal_init(gen, (d, e), torch.float32),
        "w1": fanin_init(gen, (ep, d, fe), dtype),
        "w3": fanin_init(gen, (ep, d, fe), dtype),
        "w2": fanin_init(gen, (ep, fe, d), dtype),
    }
    if cfg.num_shared_experts > 0:
        fs = fe * cfg.num_shared_experts
        p["shared"] = {
            "w1": fanin_init(gen, (d, fs), dtype),
            "w3": fanin_init(gen, (d, fs), dtype),
            "w2": fanin_init(gen, (fs, d), dtype),
        }
    return p


def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, dtype, moe: bool) -> dict:
    p = {"attn": init_attn_params(gen, cfg, dtype)}
    p |= init_norm(cfg, "ln1", cfg.d_model, dtype, gen.device)
    p |= init_norm(cfg, "ln2", cfg.d_model, dtype, gen.device)
    if moe:
        p["moe"] = init_moe_params(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp_params(gen, cfg, dtype)
    return p


def _moe(p, cfg: ModelConfig, h):
    return moe_sorted(h, p, num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                      act=act_fn(cfg.activation), capacity_factor=cfg.moe_capacity_factor,
                      shared=p.get("shared"), groups=cfg.moe_groups)


def decoder_layer_full(p, cfg: ModelConfig, x, *, attention=None):
    """Prefill layer.  Returns (x, aux_loss)."""
    h = norm(cfg, x, p, "ln1")
    x = residual(x, self_attention_full(p["attn"], cfg, h, window=cfg.sliding_window,
                                        attention=attention))
    h = norm(cfg, x, p, "ln2")
    if "moe" in p:
        mo = _moe(p["moe"], cfg, h)
        return residual(x, mo.y), mo.aux_loss
    x = residual(x, apply_mlp(p["mlp"], cfg, h))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_layer_decode(p, cfg: ModelConfig, x, cache: KVCache, *, window=None):
    """Decode layer; the MoE aux loss is dropped, as in the reference."""
    h = norm(cfg, x, p, "ln1")
    attn, cache = self_attention_decode(p["attn"], cfg, h, cache,
                                        window=window or cfg.sliding_window)
    x = residual(x, attn)
    h = norm(cfg, x, p, "ln2")
    if "moe" in p:
        return residual(x, _moe(p["moe"], cfg, h).y), cache
    return residual(x, apply_mlp(p["mlp"], cfg, h)), cache
