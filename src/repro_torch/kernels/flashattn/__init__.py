"""flashattn — flash attention (causal / sliding window, GQA), forward and
backward.

  flashattn.py — build (nvcc, sm_90a), ctypes binding and launch wrappers:
                 ``flash_attention`` (BHSD; CUDA tensors -> a kernel chosen
                 by ``route``; CPU -> plain version), ``flash_attention_fwd``
                 (the forward with each row's log-sum-exp),
                 ``flash_attention_bwd`` (dq, dk, dv) and the autograd
                 function ``FlashAttention``;
  ops.py       — ``attention`` in the model's BSHD layout;
  ref.py       — the plain versions ``flash_attention_ref``
                 (``models.attention.blocked_attention``),
                 ``flash_attention_lse_ref`` and ``flash_attention_bwd_ref``;
  csrc/        — ``flashattn_tc.cu``, the bf16 forward on the tensor cores;
                 ``flashattn.cu``, the f32 forward on the FP32 pipes;
                 ``flashattn_bwd.cu``, the backward (bf16 on the tensor
                 cores, f32 on the FP32 pipes); ``flashattn_mma.cuh``, the
                 warp-level tensor-core and copy helpers both bf16 sources
                 include.
"""

from repro_torch.kernels.flashattn.flashattn import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
)
from repro_torch.kernels.flashattn.ops import attention
from repro_torch.kernels.flashattn.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

__all__ = ["FlashAttention", "attention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_fwd", "flash_attention_lse_ref",
           "flash_attention_ref"]
