"""Public rwkv6 wkv op in the model's (B, S, D) layout (counterpart of the
JAX package's ``kernels/rwkv6_scan/ops.py``).  The kernel takes strides,
so the (B, S, D) <-> (B, H, S, K) change is a view, with no copy."""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan.rwkv6_scan import RwkvScan, rwkv6_scan


def wkv(r, k, v, logw, u, state0, head_size: int, *, chunk: int = 64, state_out=None):
    """The signature of ``models.rwkv6.chunked_wkv``; the new state goes
    into ``state_out`` when it is given (it may be ``state0``).  On CUDA
    with grad mode on and an input that requires grad, the ``RwkvScan``
    autograd function (forward and backward kernels), which takes no
    ``state_out``; otherwise ``rwkv6_scan`` (CPU tensors: the plain
    version, whose autograd is the backward)."""
    B, S, D = r.shape
    K = head_size
    H = D // K

    def heads(x):
        return x.reshape(B, S, H, K).movedim(2, 1)

    args = (heads(r), heads(k), heads(v), heads(logw.to(torch.float32)),
            u.reshape(H, K).to(torch.float32), state0)
    if r.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state0)):
        if state_out is not None:
            raise ValueError("wkv: state_out writes the state in place, which autograd "
                             "cannot follow")
        out, s1 = RwkvScan.apply(*args, chunk)
    else:
        out, s1 = rwkv6_scan(*args, chunk=chunk, state_out=state_out)
    return out.movedim(1, 2).reshape(B, S, D), s1
