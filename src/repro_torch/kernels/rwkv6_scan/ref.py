"""The plain version of rwkv6_scan (counterpart of the JAX package's
``kernels/rwkv6_scan/ref.py``): ``models.rwkv6.chunked_wkv`` adapted to the
kernel's (B, H, S, K) layout.  Its ``out`` is f32, as the reference's."""

from __future__ import annotations

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
