"""The plain version of rwkv6_scan (counterpart of the JAX package's
``kernels/rwkv6_scan/ref.py``): ``models.rwkv6.chunked_wkv`` adapted to the
kernel's (B, H, S, K) layout.  Its ``out`` is f32, as the reference's.

Beside it, what the CUDA routes compute, in plain PyTorch: the decode
step's closed form, ``decode_ref``; the two-pass decomposition of the
prefill, ``chunk_states_ref`` (the state pass's recurrence: the state
each chunk starts from) and ``chunk_outputs_ref`` (the output pass: every
chunk's output from its start state, all chunks at once).

And the backward as the backward kernels' two passes compute it, the
gradient autograd takes of ``rwkv6_scan_ref``: ``chunk_dstates_ref`` (the
dstate pass: the gradient arriving at each chunk's end, in reverse) and
``chunk_grads_ref`` (the gradient pass: every chunk's dr, dk, dv, dlogw and
its share of du from its start state and that gradient, all chunks at
once); ``rwkv6_scan_bwd_ref`` runs the three passes.  In a chunk, with
``a_t = cum_in[t]``, ``e_t = cum_ex[t]``, ``S`` the state the chunk starts
from, ``G`` the gradient at its end and ``D[t, i] = v_i . dO_t``:

    G_prev = exp(a_{L-1})[:, None] G + sum_t (r_t exp(e_t))^T dO_t
    dr_t = exp(e_t) (S dO_t) + sum_{i<t} k_i P[t,i] D[t,i] + u k_t D[t,t]
    dk_i = sum_{t>i} r_t P[t,i] D[t,i] + r_i u D[i,i] + kdec_i (G v_i)
    dv_i = sum_{t>i} A[t,i] dO_t + bonus_i dO_i + (k_i kdec_i)^T G
    du   = sum_t r_t k_t D[t,t]

with ``P[t,i] = exp(clip(e_t - a_i, -60, 0))`` and ``kdec_i =
exp(clip(a_{L-1} - a_i, -60, 0))``, as the forward takes them.  dlogw
comes from the gradients with respect to the exponents, ``de_t = r_t
(dr_t - u k_t D[t,t])``, ``da_i = -k_i (dk_i - r_i u D[i,i])`` and, at
the chunk's last step, ``exp(a_{L-1}) sum_j S[:, j] G[:, j] + sum_i k_i
kdec_i (G v_i)``: ``dlogw_s = sum_{t>=s} da_t + sum_{t>s} de_t`` within
the chunk.  Autograd gives zero through the clip where an exponent lies
below -60; these formulas keep exp(-60) there, a term below 9e-27 of
the products it scales, so the two agree to f32 rounding."""

from __future__ import annotations

import torch

from repro_torch.models.rwkv6 import CHUNK, chunked_wkv


def rwkv6_scan_ref(r, k, v, logw, u, state0, *, chunk: int = CHUNK):
    """Inputs in kernel layout (B, H, S, K); u (H, K); state (B, H, K, K)."""
    B, H, S, K = r.shape

    def flat(x):
        # (B, H, S, K) -> (B, S, H*K)
        return x.movedim(1, 2).reshape(B, S, H * K)

    out, s1 = chunked_wkv(flat(r), flat(k), flat(v), flat(logw), u.reshape(H * K), state0, K,
                          chunk=chunk)
    return out.reshape(B, S, H, K).movedim(2, 1), s1


def decode_ref(r, k, v, logw, u, state0):
    """One step (S = 1), where the chunk formulas reduce exactly (cum_ex =
    0, total = cum_in = logw, clip(0) = 0):

        out[j]  = sum_q r[q] S0[q, j] + (sum_q r[q] u[q] k[q]) v[j]
        S1[q, j] = S0[q, j] exp(logw[q]) + k[q] v[j]

    Inputs as ``rwkv6_scan_ref``'s with S = 1; returns (out (B, H, 1, K)
    f32, S1)."""
    if r.shape[2] != 1:
        raise ValueError(f"decode_ref: one step, got {r.shape[2]}")
    rf, kf, vf, w = (x[:, :, 0].to(torch.float32) for x in (r, k, v, logw))   # (B, H, K)
    bonus = (rf * u.to(torch.float32)[None] * kf).sum(-1, keepdim=True)
    out = torch.einsum("bhq,bhqj->bhj", rf, state0) + bonus * vf
    s1 = state0 * torch.exp(w)[..., None] + kf[..., :, None] * vf[..., None, :]
    return out[:, :, None], s1


def _chunks(x, L):
    """(B, H, S, K) -> (B, H, S // L, L, K) f32."""
    B, H, S, K = x.shape
    return x.reshape(B, H, S // L, L, K).to(torch.float32)


def chunk_states_ref(k, v, logw, state0, *, chunk: int = CHUNK):
    """The state pass: (the state each chunk of L = min(chunk, S) starts
    from, (B, H, S // L, K, K); the last state).  Everything but the
    carried state is computed for all chunks at once."""
    L = min(chunk, k.shape[2])
    kc, vc, lwc = _chunks(k, L), _chunks(v, L), _chunks(logw, L)
    cum_in = torch.cumsum(lwc, dim=3)
    total = cum_in[:, :, :, -1:, :]                                   # (B, H, nc, 1, K)
    k_dec = kc * torch.exp(torch.clamp(total - cum_in, -60.0, 0.0))
    update = torch.einsum("bhclk,bhclv->bhckv", k_dec, vc)
    decay = torch.exp(total)[:, :, :, 0, :, None]                     # (B, H, nc, K, 1)
    states, s = [], state0
    for c in range(kc.shape[2]):
        states.append(s)
        s = s * decay[:, :, c] + update[:, :, c]
    return torch.stack(states, 2), s


def chunk_outputs_ref(r, k, v, logw, u, states, *, chunk: int = CHUNK):
    """The output pass: out (B, H, S, K) f32 of every chunk from the state
    it starts from, ``states`` (B, H, S // L, K, K)."""
    B, H, S, K = r.shape
    L = min(chunk, S)
    rc, kc, vc, lwc = _chunks(r, L), _chunks(k, L), _chunks(v, L), _chunks(logw, L)
    cum_in = torch.cumsum(lwc, dim=3)
    cum_ex = cum_in - lwc
    inter = torch.einsum("bhclk,bhckv->bhclv", rc * torch.exp(cum_ex), states)
    expdiff = torch.exp(torch.clamp(
        cum_ex[:, :, :, :, None, :] - cum_in[:, :, :, None, :, :], -60.0, 0.0))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    A = torch.einsum("bhctk,bhcik,bhctik->bhcti", rc, kc, expdiff) * tri
    intra = torch.einsum("bhcti,bhciv->bhctv", A, vc)
    bonus = torch.einsum("bhclk,bhclk->bhcl", rc * u.to(torch.float32)[None, :, None, None, :], kc)
    return (inter + intra + bonus[..., None] * vc).reshape(B, H, S, K)


def rwkv6_scan_two_pass_ref(r, k, v, logw, u, state0, *, chunk: int = CHUNK):
    """rwkv6_scan_ref's result by the state pass, then the output pass."""
    states, s1 = chunk_states_ref(k, v, logw, state0, chunk=chunk)
    return chunk_outputs_ref(r, k, v, logw, u, states, chunk=chunk), s1


def chunk_dstates_ref(r, logw, dout, ds1, *, chunk: int = CHUNK):
    """The dstate pass: (the gradient arriving at each chunk's end,
    (B, H, S // L, K, K), with the last chunk's equal to ``ds1``; the
    gradient of the state the first chunk starts from).  Everything but
    the carried gradient is computed for all chunks at once."""
    L = min(chunk, r.shape[2])
    rc, lwc, doc = _chunks(r, L), _chunks(logw, L), _chunks(dout, L)
    cum_in = torch.cumsum(lwc, dim=3)
    r_dec = rc * torch.exp(cum_in - lwc)
    into = torch.einsum("bhclk,bhclv->bhckv", r_dec, doc)
    decay = torch.exp(cum_in[:, :, :, -1, :, None])                  # (B, H, nc, K, 1)
    grads, g = [None] * rc.shape[2], ds1.to(torch.float32)
    for c in reversed(range(rc.shape[2])):
        grads[c] = g
        g = g * decay[:, :, c] + into[:, :, c]
    return torch.stack(grads, 2), g


def chunk_grads_ref(r, k, v, logw, u, states, dout, dstates, *, chunk: int = CHUNK):
    """The gradient pass: (dr, dk, dv, dlogw) (B, H, S, K) f32 and du
    (B, S // L, H, K), each (batch, chunk)'s share, from the state each
    chunk starts from, ``states``, and the gradient at its end,
    ``dstates`` (both (B, H, S // L, K, K))."""
    B, H, S, K = r.shape
    L = min(chunk, S)
    rc, kc, vc, lwc, doc = (_chunks(x, L) for x in (r, k, v, logw, dout))
    uf = u.to(torch.float32)[None, :, None, None, :]
    cum_in = torch.cumsum(lwc, dim=3)
    cum_ex = cum_in - lwc
    total = cum_in[:, :, :, -1:, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    P = torch.exp(torch.clamp(cum_ex[:, :, :, :, None, :] - cum_in[:, :, :, None, :, :],
                              -60.0, 0.0)) * tri[..., None]          # (B, H, nc, t, i, K)
    D = torch.einsum("bhcik,bhctk->bhcti", vc, doc)
    Dd = torch.diagonal(D, 0, -2, -1)[..., None]                     # D[t, t]
    kdec = torch.exp(torch.clamp(total - cum_in, -60.0, 0.0))
    Gv = torch.einsum("bhcqj,bhcij->bhciq", dstates, vc)
    inter = torch.exp(cum_ex) * torch.einsum("bhcqj,bhctj->bhctq", states, doc)
    dr_pair = torch.einsum("bhcik,bhctik,bhcti->bhctk", kc, P, D)
    dk_pair = torch.einsum("bhctk,bhctik,bhcti->bhcik", rc, P, D)
    A = torch.einsum("bhctk,bhcik,bhctik->bhcti", rc, kc, P)
    bonus = (rc * uf * kc).sum(-1, keepdim=True)
    dr = inter + dr_pair + uf * kc * Dd
    dk = dk_pair + rc * uf * Dd + kdec * Gv
    dv = (torch.einsum("bhcti,bhctj->bhcij", A, doc) + bonus * doc
          + torch.einsum("bhciq,bhcqj->bhcij", kc * kdec, dstates))
    de = rc * (inter + dr_pair)
    da = -kc * (dk_pair + kdec * Gv)
    da[:, :, :, -1] += (torch.exp(total[:, :, :, 0]) * (states * dstates).sum(-1)
                        + (kc * kdec * Gv).sum(3))
    rev = torch.flip(torch.cumsum(torch.flip(da + de, [3]), 3), [3])     # sum over t >= s
    dw = rev - de
    du = (rc * kc * Dd).sum(3).movedim(2, 1)                        # (B, nc, H, K)
    flat = lambda x: x.reshape(B, H, S, K)
    return flat(dr), flat(dk), flat(dv), flat(dw), du


def rwkv6_scan_bwd_ref(r, k, v, logw, u, state0, dout, ds1, *, chunk: int = CHUNK):
    """The gradients of ``rwkv6_scan_ref``'s (out, s1) against (dout, ds1)
    by the backward kernels' passes: (dr, dk, dv, dlogw (B, H, S, K), du
    (H, K), dstate0 (B, H, K, K)), all f32."""
    states, _ = chunk_states_ref(k, v, logw, state0, chunk=chunk)
    dstates, dstate0 = chunk_dstates_ref(r, logw, dout, ds1, chunk=chunk)
    dr, dk, dv, dw, du = chunk_grads_ref(r, k, v, logw, u, states, dout, dstates, chunk=chunk)
    return dr, dk, dv, dw, du.sum((0, 1)), dstate0
