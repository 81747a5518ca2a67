"""flashattn — forward flash attention (causal / sliding window, GQA).

  flashattn.py — build (nvcc, sm_90a), ctypes binding and launch wrapper
                 ``flash_attention`` (BHSD; CUDA tensors -> a kernel chosen
                 by ``route``; CPU -> plain version);
  ops.py       — ``attention`` in the model's BSHD layout;
  ref.py       — the plain version ``flash_attention_ref``
                 (``models.attention.blocked_attention``);
  csrc/        — ``flashattn_tc.cu``, the bf16 kernel on the tensor cores;
                 ``flashattn.cu``, the f32 kernel on the FP32 pipes.
"""

from repro_torch.kernels.flashattn.flashattn import flash_attention
from repro_torch.kernels.flashattn.ops import attention
from repro_torch.kernels.flashattn.ref import flash_attention_ref

__all__ = ["attention", "flash_attention", "flash_attention_ref"]
