"""Public flash attention op in the model's BSHD layout (counterpart of
the JAX package's ``kernels/flashattn/ops.py``).  The kernels take strides
and mask ragged lengths, so the BSHD <-> BHSD change is a view, with no
copy and no padding of the sequence (bf16 with a head_dim that is no
multiple of 8 is copied once, see ``flashattn.route``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flashattn.flashattn import FlashAttention, flash_attention


def attention(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) — model layout (BSHD).  On
    CUDA with grad mode on and an input that requires grad, the
    ``FlashAttention`` autograd function (forward and backward kernels);
    otherwise ``flash_attention`` (CPU tensors: the plain version, whose
    autograd is the backward)."""
    qh, kh, vh = (t.movedim(1, 2) for t in (q, k, v))
    if q.is_cuda and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(qh, kh, vh, causal, window)
    else:
        out = flash_attention(qh, kh, vh, causal=causal, window=window)
    return out.movedim(1, 2)
