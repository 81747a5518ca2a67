"""The plain versions of flash attention, in the kernel's BHSD layout:

  * ``flash_attention_ref`` — the forward, the port's ``blocked_attention``
    (``models/attention.py``), as the JAX package's
    ``kernels/flashattn/ref.py`` re-exports its own;
  * ``flash_attention_lse_ref`` — that forward and each row's log-sum-exp
    of its scaled, masked scores, what the forward kernels write for the
    backward;
  * ``flash_attention_bwd_ref`` — the gradient of the forward with respect
    to q, k and v, the function ``jax.grad`` takes of the reference's
    attention, in f32 and blocked over queries so that it fits at S 8192.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, blocked_attention, softmax_scale


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd) — BHSD like the kernel."""
    out = blocked_attention(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                            causal=causal, window=window)
    return out.movedim(1, 2)


def _mask(q0: int, q1: int, Sk: int, causal: bool, window, device) -> torch.Tensor:
    """(q1 - q0, Sk) bool: key k is visible to query row q."""
    qp = torch.arange(q0, q1, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((q1 - q0, Sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (qp - kp < window)
    return ok


def _grouped(t: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, H, ...) -> (B, KV, G, ...) in f32: query head h is KV head h // G's."""
    B, H = t.shape[:2]
    return t.float().reshape(B, KV, H // KV, *t.shape[2:])


def _scores(qb, kf, q0, q1, causal, window, hd):
    s = torch.einsum("bngqd,bnkd->bngqk", qb, kf) * softmax_scale(hd)
    ok = _mask(q0, q1, kf.shape[2], causal, window, kf.device)
    return s, ok


def flash_attention_lse_ref(q, k, v, *, causal=True, window=None, q_block: int = 256):
    """(out, lse): the plain forward and lse (B, H, Sq) f32, the log of each
    row's sum of exp(scores * scale) over the keys it sees."""
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    qg, kf = _grouped(q, KV), k.float()
    lse = []
    for q0 in range(0, Sq, q_block):
        q1 = min(Sq, q0 + q_block)
        s, ok = _scores(qg[:, :, :, q0:q1], kf, q0, q1, causal, window, hd)
        lse.append(torch.logsumexp(s.masked_fill(~ok, NEG_INF), dim=-1))
    lse = torch.cat(lse, dim=-1).reshape(B, H, Sq)
    return flash_attention_ref(q, k, v, causal=causal, window=window), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, window=None,
                            q_block: int = 256):
    """(dq, dk, dv) in the dtypes of q, k and v: the gradient of
    ``sum(flash_attention(q, k, v) * dout)``.  With P = exp(S * scale -
    lse) on the visible keys and D = rowsum(dout * out), per block of
    queries: dV += P^T dO, dS = P * (dO V^T - D), dQ = dS K * scale, dK +=
    dS^T Q * scale; GQA sums dK and dV over the group's heads.  All in f32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = softmax_scale(hd)
    qg, dog = _grouped(q, KV), _grouped(dout, KV)
    lg = _grouped(lse, KV)
    Dg = _grouped((dout.float() * out.float()).sum(dim=-1), KV)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, Sq, q_block):
        q1 = min(Sq, q0 + q_block)
        qb, dob = qg[:, :, :, q0:q1], dog[:, :, :, q0:q1]
        s, ok = _scores(qb, kf, q0, q1, causal, window, hd)
        p = torch.where(ok, torch.exp(s - lg[..., q0:q1, None]), 0.0)
        dv += torch.einsum("bngqk,bngqd->bnkd", p, dob)
        ds = p * (torch.einsum("bngqd,bnkd->bngqk", dob, vf) - Dg[..., q0:q1, None])
        dq[:, :, :, q0:q1] = torch.einsum("bngqk,bnkd->bngqd", ds, kf) * scale
        dk += torch.einsum("bngqk,bngqd->bnkd", ds, qb) * scale
    return dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
