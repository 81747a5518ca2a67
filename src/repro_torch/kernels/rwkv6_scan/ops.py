"""Public rwkv6 wkv op in the model's (B, S, D) layout (counterpart of the
JAX package's ``kernels/rwkv6_scan/ops.py``).  The kernel takes strides,
so the (B, S, D) <-> (B, H, S, K) change is a view, with no copy."""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan


def wkv(r, k, v, logw, u, state0, head_size: int, *, chunk: int = 64, state_out=None):
    """The signature of ``models.rwkv6.chunked_wkv``; the new state goes
    into ``state_out`` when it is given (it may be ``state0``)."""
    B, S, D = r.shape
    K = head_size
    H = D // K

    def heads(x):
        return x.reshape(B, S, H, K).movedim(2, 1)

    out, s1 = rwkv6_scan(heads(r), heads(k), heads(v), heads(logw.to(torch.float32)),
                         u.reshape(H, K).to(torch.float32), state0, chunk=chunk,
                         state_out=state_out)
    return out.movedim(1, 2).reshape(B, S, D), s1
