"""The plain version of flash attention: the port's ``blocked_attention``
(``models/attention.py``) in the kernel's BHSD layout, as the JAX
package's ``kernels/flashattn/ref.py`` re-exports its own."""

from __future__ import annotations

from repro_torch.models.attention import blocked_attention


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd) — BHSD like the kernel."""
    out = blocked_attention(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                            causal=causal, window=window)
    return out.movedim(1, 2)
