"""rwkv6_scan — the RWKV6 WKV recurrence (chunked linear attention with
data-dependent decay).

  rwkv6_scan.py — build (nvcc, sm_90a), ctypes binding and launch wrapper
                  ``rwkv6_scan`` ((B, H, S, K); CUDA tensors -> kernel; CPU
                  -> plain version);
  ops.py        — ``wkv`` in the model's (B, S, D) layout;
  ref.py        — the plain version ``rwkv6_scan_ref``
                  (``models.rwkv6.chunked_wkv``), and what each CUDA route
                  computes in plain PyTorch (``decode_ref``, the two
                  passes);
  csrc/         — ``rwkv6_scan.cu``, the kernels.
"""

from repro_torch.kernels.rwkv6_scan.ops import wkv
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan

__all__ = ["rwkv6_scan", "rwkv6_scan_ref", "wkv"]
