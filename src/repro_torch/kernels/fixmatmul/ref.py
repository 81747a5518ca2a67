"""The plain version of fixmatmul (counterpart of the JAX package's
``kernels/fixmatmul/ref.py`` ``fixmatmul_ref``).

    out[m, n] = (f32(sum_k xq[m, k] * wq[k, n]) * sx[m]) * sw[n]

The int32 sum is exact either way: on the CPU an int32 ``torch.matmul``;
on the card, where integer ``matmul`` is not implemented, a float64 product
of the int8 values, exact because |sum| <= K * 128 * 128 < 2**53.  The two
scale multiplies run in f32 in that order, as the kernel's epilogue does.
"""

from __future__ import annotations

import torch


def fixmatmul_ref(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if xq.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int32), wq.to(torch.int32))
    else:
        acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.int32)
    out = acc.to(torch.float32) * sx[:, None].to(torch.float32) * sw[None, :].to(torch.float32)
    return out.to(out_dtype)
