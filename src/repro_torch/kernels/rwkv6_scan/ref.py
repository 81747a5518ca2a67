"""The plain version of rwkv6_scan (counterpart of the JAX package's
``kernels/rwkv6_scan/ref.py``): ``models.rwkv6.chunked_wkv`` adapted to the
kernel's (B, H, S, K) layout.  Its ``out`` is f32, as the reference's.

Beside it, what the CUDA routes compute, in plain PyTorch: the decode
step's closed form, ``decode_ref``; the two-pass decomposition of the
prefill, ``chunk_states_ref`` (the state pass's recurrence: the state
each chunk starts from) and ``chunk_outputs_ref`` (the output pass: every
chunk's output from its start state, all chunks at once)."""

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
