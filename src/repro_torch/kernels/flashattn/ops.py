"""Public flash attention op in the model's BSHD layout (counterpart of
the JAX package's ``kernels/flashattn/ops.py``).  The kernels take strides
and mask ragged lengths, so the BSHD <-> BHSD change is a view, with no
copy and no padding of the sequence (bf16 with a head_dim that is no
multiple of 8 is copied once, see ``flashattn.route``)."""

from __future__ import annotations

from repro_torch.kernels.flashattn.flashattn import flash_attention


def attention(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) — model layout (BSHD)."""
    out = flash_attention(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                          causal=causal, window=window)
    return out.movedim(1, 2)
