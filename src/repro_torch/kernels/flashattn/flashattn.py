"""The flash attention CUDA kernel: build, bind and launch.

Replaces the TPU kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flashattn/flashattn.py``, ``pl.pallas_call``).  The
source is ``csrc/flashattn.cu`` (see the note at its top for what bounds
it), built by ``LIBRARY`` (``kernels/nvcc.py``) with nvcc for sm_90a at
first use and loaded with ``ctypes``.

A CUDA tensor launches the kernel, and a failed build or launch raises;
only CPU tensors take the plain version (``ref.flash_attention_ref``).
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.flashattn.ref import flash_attention_ref
from repro_torch.kernels.nvcc import CudaLibrary, check_launch
from repro_torch.models.attention import softmax_scale

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("flashattn", CSRC, "flashattn.cu", (), _bind)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Forward attention, q (B, H, Sq, hd), k/v (B, KV, Sk, hd) -> like q.
    GQA by ``h // (H // KV)``; causal and sliding-window masks; bf16 or
    f32.  Any strides with the last dimension contiguous.  CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    B, H, Sq, hd = q.shape
    Bk, KV, Sk, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: operands on different devices")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    lib = LIBRARY.load()
    out = torch.empty_like(q)               # q's layout, so a BSHD view stays one
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out) for s in t.stride()[:3]])
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, KV, Sq, Sk, hd, int(causal), window or 0, softmax_scale(hd),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
