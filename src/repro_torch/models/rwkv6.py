"""RWKV6 (Finch, arXiv:2404.05892) — attention-free time mix with
data-dependent decay, plus squared-ReLU channel mix (counterpart of
``repro.models.rwkv6``).

The time-mix recurrence per head (head size K):

    out_t = r_t . S_{t-1}  +  (r_t * u . k_t) v_t
    S_t   = diag(w_t) S_{t-1} + k_t (x) v_t
    w_t   = exp(-exp(w0 + tanh(x_t W_a) W_b))      (data-dependent decay)

``chunked_wkv`` computes it with the chunked linear-attention algorithm
(chunk length ``CHUNK``): intra-chunk via an (L, L, K) decay-weighted
contraction in log space (all exponents <= 0), inter-chunk via the carried
state.  It is the plain version of the ``rwkv6_scan`` kernel, which
``time_mix`` calls through ``kernels.rwkv6_scan.ops.wkv``.

As in the reference, the token-shift interpolation is static per channel
(RWKV5-style); the decay is fully data-dependent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import fanin_init, normal_init
from repro_torch.sharding import local
from repro_torch.sharding.api import logical

CHUNK = 64
LORA_RANK = 64


class RWKVState(NamedTuple):
    """Recurrent state; the model stacks each field over layers."""

    wkv: torch.Tensor        # (B, H, K, K) fp32 linear-attention state
    shift_t: torch.Tensor    # (B, D) last input to the time-mix
    shift_c: torch.Tensor    # (B, D) last input to the channel-mix


def init_time_mix(gen: torch.Generator, d: int, dtype) -> dict:
    return {
        "mu_r": normal_init(gen, (d,), dtype, 0.5),
        "mu_k": normal_init(gen, (d,), dtype, 0.5),
        "mu_v": normal_init(gen, (d,), dtype, 0.5),
        "mu_g": normal_init(gen, (d,), dtype, 0.5),
        "mu_w": normal_init(gen, (d,), dtype, 0.5),
        "wr": fanin_init(gen, (d, d), dtype),
        "wk": fanin_init(gen, (d, d), dtype),
        "wv": fanin_init(gen, (d, d), dtype),
        "wg": fanin_init(gen, (d, d), dtype),
        "wo": fanin_init(gen, (d, d), dtype),
        # decay LoRA: w0 spread over [-6, -4] gives per-channel half-lives
        # from ~7 to ~55 tokens at init.
        "w0": torch.linspace(-6.0, -4.0, d, dtype=torch.float32, device=gen.device),
        "wa": normal_init(gen, (d, LORA_RANK), dtype, 0.01),
        "wb": normal_init(gen, (LORA_RANK, d), dtype, 0.01),
        "u": normal_init(gen, (d,), torch.float32, 0.5),
        "ln_x": torch.ones((d,), dtype=torch.float32, device=gen.device),
    }


def init_channel_mix(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {
        "mu_k": normal_init(gen, (d,), dtype, 0.5),
        "mu_r": normal_init(gen, (d,), dtype, 0.5),
        "wk": fanin_init(gen, (d, f), dtype),
        "wv": fanin_init(gen, (f, d), dtype),
        "wr": fanin_init(gen, (d, d), dtype),
    }


def _token_shift(x, shift_state):
    """The previous token along seq (the carried state before the first)."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def chunked_wkv(r, k, v, logw, u, state, head_size: int, *, chunk: int = CHUNK):
    """Chunked RWKV6 recurrence.

    r/k/v: (B, S, D); logw: (B, S, D) log-decay (<= 0); u: (D,) fp32;
    state: (B, H, K, K) fp32.  Returns (out (B, S, D) fp32, new state).
    ``chunk`` is the chunk length (the reference fixes it at ``CHUNK``).
    """
    B, S, D = r.shape
    K = head_size
    H = D // K
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"chunked_wkv: seq {S} is not a multiple of the chunk {L}")
    nc = S // L
    u_ = u.reshape(H, K).to(torch.float32)

    # (nc, B, H, L, K), staged in the input dtype; cast per chunk
    def chunks(x):
        return x.reshape(B, nc, L, H, K).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(logw)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    S0 = state
    outs = []
    for c in range(nc):
        rb = rc[c].to(torch.float32)
        kb = kc[c].to(torch.float32)
        vb = vc[c].to(torch.float32)
        lwb = lwc[c].to(torch.float32)
        cum_in = torch.cumsum(lwb, dim=2)                # inclusive
        cum_ex = cum_in - lwb                            # exclusive
        # inter-chunk: decay of S0 up to step t is exp(cum_ex[t])
        r_dec = rb * torch.exp(cum_ex)
        out_inter = torch.einsum("bhlk,bhkv->bhlv", r_dec, S0)
        # intra-chunk: A[t,i] = sum_k r_t k_i exp(cum_ex[t]-cum_in[i]), i<t
        expdiff = torch.exp(torch.clamp(
            cum_ex[:, :, :, None, :] - cum_in[:, :, None, :, :], -60.0, 0.0))
        A = torch.einsum("bhtk,bhik,bhtik->bhti", rb, kb, expdiff) * tri[None, None]
        out_intra = torch.einsum("bhti,bhiv->bhtv", A, vb)
        # bonus diagonal term
        bonus = torch.einsum("bhlk,bhlk->bhl", rb * u_[None, :, None, :], kb)
        out_diag = bonus[..., None] * vb
        outs.append(out_inter + out_intra + out_diag)
        # state update
        total = cum_in[:, :, -1:, :]                     # (B, H, 1, K)
        k_dec = kb * torch.exp(torch.clamp(total - cum_in, -60.0, 0.0))
        S0 = S0 * torch.exp(total.squeeze(2))[..., None] + torch.einsum(
            "bhlk,bhlv->bhkv", k_dec, vb)
    # (nc, B, H, L, K) -> (B, S, D)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, D)
    return out, S0


def group_norm_heads(x, scale, head_size, eps=1e-5):
    """Per-head LayerNorm of the wkv output (RWKV's GroupNorm)."""
    B, S, D = x.shape
    H = D // head_size
    xh = x.reshape(B, S, H, head_size).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, D) * scale).to(x.dtype)


def time_mix(params, x, shift_state, wkv_state, head_size, *, wkv=None, state_out=None):
    """Full RWKV6 time-mix block, x: (B, S, D).  Returns (out, the new
    shift state, the new wkv state).  ``wkv`` defaults to the rwkv6_scan
    op, which writes the new state into ``state_out`` when it is given (it
    may be ``wkv_state`` itself); a check passes ``chunked_wkv`` instead to
    hold the kernel's path against the plain version."""
    prev = _token_shift(x, shift_state)
    xx = prev - x

    def mix(mu):
        return x + xx * mu

    xr, xk, xv, xg, xw = (mix(params[f"mu_{c}"]) for c in "rkvgw")
    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = xg @ params["wg"]
    # data-dependent decay (fp32)
    lora = torch.tanh(xw @ params["wa"]).to(torch.float32) @ params["wb"].to(torch.float32)
    logw = -torch.exp(params["w0"].to(torch.float32) + lora)       # <= 0
    kw = {}
    if wkv is None:
        from repro_torch.kernels.rwkv6_scan.ops import wkv

        kw = {"state_out": state_out}
    if isinstance(r, DTensor):      # the kernel takes each rank's (batch, head) shard
        out, wkv_state = local.wkv(wkv, r, k, v, logw, params["u"], wkv_state, head_size, **kw)
    else:
        out, wkv_state = wkv(r, k, v, logw, params["u"], wkv_state, head_size, **kw)
    out = group_norm_heads(out.to(x.dtype), params["ln_x"], head_size)
    out = out * F.silu(g)
    out = out @ params["wo"]
    return out, x[:, -1, :], wkv_state


def channel_mix(params, x, shift_state):
    prev = _token_shift(x, shift_state)
    xx = prev - x
    xk = x + xx * params["mu_k"]
    xr = x + xx * params["mu_r"]
    k = torch.square(F.relu(xk @ params["wk"]))
    k = logical(k, "batch", "seq", "ff")
    kv = k @ params["wv"]
    rr = torch.sigmoid(xr @ params["wr"])
    return rr * kv, x[:, -1, :]
