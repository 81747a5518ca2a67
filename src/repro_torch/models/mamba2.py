"""Mamba2 (SSD) layer of the zamba2 hybrid backbone (counterpart of
``repro.models.mamba2``).

State-space recurrence per head (head dim P, state dim N):

    a_t = exp(dt_t * A)                      (A < 0 scalar per head)
    S_t = a_t S_{t-1} + dt_t * x_t (x) B_t   (S: (P, N))
    y_t = S_t C_t + D_h x_t

computed chunk-parallel (the SSD algorithm): intra-chunk via a decay-masked
(L, L) "attention" matrix in log space, inter-chunk via the carried state.
Plain PyTorch: the reference has no Pallas kernel for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import fanin_init, normal_init, rmsnorm
from repro_torch.sharding import local
from repro_torch.sharding.api import logical

CHUNK = 64


class MambaState(NamedTuple):
    ssd: torch.Tensor        # (B, H, P, N) fp32
    conv: torch.Tensor       # (B, W-1, conv_channels) rolling conv input, [x | B | C]


def dims(cfg):
    inner = cfg.ssm_expand * cfg.d_model
    nheads = inner // cfg.ssm_head_dim
    return inner, nheads


def init_mamba_params(gen: torch.Generator, cfg, dtype) -> dict:
    """Separate z/x/B/C/dt projections (not one fused in_proj), as the
    reference keeps them; ``a_log``, ``dt_bias``, ``d_skip`` and ``norm``
    in f32."""
    d, dev = cfg.d_model, gen.device
    inner, nheads = dims(cfg)
    n = cfg.ssm_state
    w = cfg.ssm_conv_width
    zeros = lambda k: torch.zeros((k,), dtype=dtype, device=dev)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return {
        "wz": fanin_init(gen, (d, inner), dtype),
        "wx": fanin_init(gen, (d, inner), dtype),
        "wb": fanin_init(gen, (d, n), dtype),
        "wc": fanin_init(gen, (d, n), dtype),
        "wdt": fanin_init(gen, (d, nheads), dtype),
        "conv_x_w": normal_init(gen, (w, inner), dtype, 0.1),
        "conv_x_b": zeros(inner),
        "conv_b_w": normal_init(gen, (w, n), dtype, 0.1),
        "conv_b_b": zeros(n),
        "conv_c_w": normal_init(gen, (w, n), dtype, 0.1),
        "conv_c_b": zeros(n),
        "a_log": f32(np.log(np.linspace(1.0, 16.0, nheads, dtype=np.float32))),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "norm": torch.ones((inner,), dtype=torch.float32, device=dev),
        "out_proj": fanin_init(gen, (inner, d), dtype),
    }


def _causal_conv(x, w, b, carry=None):
    """Depthwise causal conv along seq, f32 accumulation, then silu.
    x: (B, S, C); w: (W, C); ``carry`` (B, W-1, C): the previous inputs
    (decode).  Returns (out like x, the new carry)."""
    B, S, C = x.shape
    W = w.shape[0]
    if carry is None:
        carry = x.new_zeros((B, W - 1, C))
    xp = torch.cat([carry, x], dim=1)                  # (B, S+W-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i : i + S, :].to(torch.float32) * w[i].to(torch.float32)
    out = out + b.to(torch.float32)
    new_carry = xp[:, S:, :] if W > 1 else carry
    return F.silu(out).to(x.dtype), new_carry


def chunked_ssd(x, dt, B_, C_, a_log, d_skip, state):
    """x: (B,S,H,P); dt: (B,S,H) fp32; B_/C_: (B,S,N); state: (B,H,P,N) fp32.
    Returns (y (B,S,H,P) f32, the state after the last chunk).

    The reference's scan step per chunk, in f32: the terms that do not
    need the carried state (the intra-chunk product, each chunk's state
    increment and decay) run for all chunks at once, and only the state
    recurrence walks the chunks.  The reference casts each chunk to f32
    inside its step to bound training memory; here the whole sequence is
    cast at once (the same f32 arithmetic; ~0.5 GB at zamba2's B 1,
    S 8192 prefill), since a launch a chunk per term left the card idle
    behind the host."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    L = min(CHUNK, S)
    if S % L:
        raise ValueError(f"chunked_ssd: S {S} is no multiple of its chunk {L}")
    nc = S // L

    A = -torch.exp(a_log)                              # (H,) < 0
    l = dt * A[None, None, :]                          # (B,S,H) log decay <= 0
    f32 = torch.float32
    xc = x.reshape(Bb, nc, L, H, P).to(f32)
    dtc = dt.reshape(Bb, nc, L, H)
    Bc = B_.reshape(Bb, nc, L, N).to(f32)
    Cc = C_.reshape(Bb, nc, L, N).to(f32)
    cum = torch.cumsum(l.reshape(Bb, nc, L, H), dim=2)          # inclusive, per chunk
    # intra: M[t,i] = exp(cum[t]-cum[i]) (C_t.B_i) dt_i, i<=t
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    diff = torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :], -60.0, 0.0)
    M = torch.einsum("bctn,bcin->bcti", Cc, Bc)[..., None] * torch.exp(diff)
    M = M * dtc[:, :, None, :, :] * tri[None, None, :, :, None]     # (B,c,t,i,H)
    y = torch.einsum("bctih,bcihp->bcthp", M, xc) + d_skip[None, None, None, :, None] * xc
    # state: S1 = exp(cum[-1]) S0 + sum_i exp(cum[-1]-cum[i]) dt_i x_i (x) B_i
    total = cum[:, :, -1:, :]                                     # (B,c,1,H)
    w_i = torch.exp(torch.clamp(total - cum, -60.0, 0.0)) * dtc     # (B,c,L,H)
    dS = torch.einsum("bclh,bclhp,bcln->bchpn", w_i, xc, Bc)
    decay = torch.exp(total[:, :, 0, :, None, None])               # (B,c,H,1,1)
    starts = []
    S0 = state
    for a, ds in zip(decay.unbind(1), dS.unbind(1)):
        starts.append(S0)
        S0 = S0 * a + ds
    # inter: y_inter[t] = exp(cum[t]) * C_t . S0 of the chunk
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc, torch.stack(starts, dim=1))
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(Bb, S, H, P), S0


def mamba_block(params, cfg, x, state: MambaState):
    """Full Mamba2 block.  x: (B, S, D).  Returns (out (B, S, D), the new
    MambaState)."""
    B, S, D = x.shape
    inner, nheads = dims(cfg)
    n = cfg.ssm_state
    P = cfg.ssm_head_dim

    z = x @ params["wz"]
    xin = x @ params["wx"]
    B_ = x @ params["wb"]
    C_ = x @ params["wc"]
    dt = x @ params["wdt"]
    z = logical(z, "batch", "seq", "ff")
    xin = logical(xin, "batch", "seq", "ff")
    # Depthwise causal convs per stream (carry order: [x | B | C]).
    cx = state.conv[:, :, :inner]
    cb = state.conv[:, :, inner : inner + n]
    cc = state.conv[:, :, inner + n :]
    xin, cx2 = _causal_conv(xin, params["conv_x_w"], params["conv_x_b"], cx)
    B_, cb2 = _causal_conv(B_, params["conv_b_w"], params["conv_b_b"], cb)
    C_, cc2 = _causal_conv(C_, params["conv_c_w"], params["conv_c_b"], cc)
    conv_carry = torch.cat([cx2, cb2, cc2], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    xh = xin.reshape(B, S, nheads, P)
    ssd_args = (xh, dt, B_, C_, params["a_log"], params["d_skip"], state.ssd)
    if isinstance(xh, DTensor):
        y, ssd_state = local.ssd(chunked_ssd, *ssd_args)
    else:
        y, ssd_state = chunked_ssd(*ssd_args)
    y = y.reshape(B, S, inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, params["norm"], 1e-5)
    out = y @ params["out_proj"]
    return out, MambaState(ssd=ssd_state, conv=conv_carry)
