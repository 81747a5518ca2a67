"""The flash attention CUDA kernels: build, bind and launch.

Replace the TPU kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flashattn/flashattn.py``, ``pl.pallas_call``), by
dtype (see the notes at the top of the sources for what bounds each):

  bf16 — ``csrc/flashattn_tc.cu`` on the tensor cores (``mma.sync``,
         ``ldmatrix``, ``cp.async``), built by ``TC_LIBRARY``;
  f32  — ``csrc/flashattn.cu`` on the FP32 pipes, built by ``LIBRARY``.

Both are built by ``kernels/nvcc.py`` with nvcc for sm_90a at first use and
loaded with ``ctypes``.  ``route`` picks the kernel, and whether bf16
operands first go through a zero-padded contiguous copy.  A CUDA tensor
launches a kernel, and a failed build or launch raises; only CPU tensors
take the plain version (``ref.flash_attention_ref``).
``flash_attention.launches`` counts kernel launches,
``flash_attention.tc_launches`` those of the tensor-core kernel.

The backward (``csrc/flashattn_bwd.cu``, built by ``BWD_LIBRARY``) is
``flash_attention_bwd``: bf16 on the tensor cores, f32 on the FP32 pipes,
routed by the same ``route`` (bf16 operands it marks ``padded_copy`` go
through zero-padded contiguous copies, and the gradients are copied back
into their operands' layout).  ``FlashAttention`` is the autograd function
that runs the forward kernel with its log-sum-exp output and the backward
kernels, and ``ops.attention`` takes it on CUDA when an input requires
grad.  ``flash_attention`` itself still refuses such inputs.
``flash_attention.bwd_launches`` counts the backward's kernel launches,
``BWD_KERNELS`` (D, dK/dV, dQ) a call, and
``flash_attention.bwd_tc_launches`` those on the tensor cores,
``BWD_TC_KERNELS`` (dK/dV, dQ) a bf16 call.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.flashattn.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.nvcc import CudaLibrary, check_launch
from repro_torch.models.attention import softmax_scale

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_HEAD_DIM = 128


def _binder(name: str, n_ptrs: int, n_ints: int):
    """Binds the launch function ``name``: ``n_ptrs`` pointers, the
    strides, ``n_ints`` ints, the scale and the stream."""
    def bind(lib) -> None:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return bind


def _binders(*binds):
    def bind(lib) -> None:
        for b in binds:
            b(lib)
    return bind


# The warp-level tensor-core and copy helpers of both bf16 sources.
MMA_HEADER = "flashattn_mma.cuh"
# The forward entries take q, k, v, out and lse (NULL: not written).
LIBRARY = CudaLibrary("flashattn", CSRC, "flashattn.cu", (),
                      _binder("flash_attention_launch", 5, 8))
# The tensor-core entry also takes hd_pad, the instance ``route`` chose.
TC_LIBRARY = CudaLibrary("flashattn_tc", CSRC, "flashattn_tc.cu", (MMA_HEADER,),
                         _binder("flash_attention_tc_launch", 5, 9))
BWD_KERNELS = 3                    # rowdot (D), dkdv, dq: the launches of one backward call
BWD_TC_KERNELS = 2                 # of those, on the tensor cores in a bf16 call: dkdv, dq
# q, k, v, out, dout, lse, D, dq, dk, dv; B, H, KV, S, hd, causal, window (f32 entry);
# the tensor-core entry also takes hd_pad after hd.
BWD_LIBRARY = CudaLibrary("flashattn_bwd", CSRC, "flashattn_bwd.cu", (MMA_HEADER,),
                          _binders(_binder("flash_attention_bwd_launch", 10, 7),
                                   _binder("flash_attention_bwd_tc_launch", 10, 8)))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Route(NamedTuple):
    kernel: str          # "mma": bf16 on the tensor cores; "fp32": f32 on the FP32 pipes
    hd_pad: int          # the kernel instance launched (mma: roundup(hd, 16), passed to the C entry)
    padded_copy: bool    # q/k/v go through zero-padded contiguous (..., roundup(hd, 8)) copies


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> Route:
    """Which kernel takes these operands (q, k, v, and for the backward
    out and dout too).  The tensor-core kernels copy 16-byte rows, so they
    need hd % 8 == 0, a contiguous last dimension, 16-byte aligned pointers
    and strides that are multiples of 8; operands that miss any of that
    are copied first."""
    hd = q.shape[-1]
    if q.dtype == torch.float32:
        return Route("fp32", hd, False)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    aligned = hd % 8 == 0 and all(
        t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
        for t in (q, k, v, *more))
    return Route("mma", _round_up(hd, 16), not aligned)


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    buf = t.new_zeros((*t.shape[:-1], width))
    buf[..., :t.shape[-1]] = t
    return buf


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    B, H, Sq, hd = q.shape
    Bk, KV, Sk, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Forward attention, q (B, H, Sq, hd), k/v (B, KV, Sk, hd) -> like q.
    GQA by ``h // (H // KV)``; causal and sliding-window masks; bf16 or
    f32.  Any strides.  CUDA tensors launch a kernel (or raise); CPU
    tensors take the plain version."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    refuse_grad("flash_attention", q, k, v)
    return _launch(q, k, v, causal, window, None)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None):
    """(out, lse): the forward and each row's log-sum-exp (B, H, Sq) f32,
    which the backward takes.  CUDA tensors launch the forward kernel with
    its lse output; CPU tensors take ``ref.flash_attention_lse_ref``."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    B, H, Sq, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, lse), lse


def _launch(q, k, v, causal, window, lse):
    """One forward launch on the kernel ``route`` picks; writes ``lse``
    (B, H, Sq) f32 when it is given."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dev = q.device
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    r = route(q, k, v)
    if r.padded_copy:
        q, k, v = (_padded(t, _round_up(hd, 8)) for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)               # q's layout, so a BSHD view stays one
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out) for s in t.stride()[:3]])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), strides)
    mask = (int(causal), window or 0, softmax_scale(hd), torch.cuda.current_stream(dev).cuda_stream)
    if r.kernel == "mma":
        err = TC_LIBRARY.load().flash_attention_tc_launch(
            *ptrs, B, H, KV, Sq, Sk, q.shape[-1], r.hd_pad, *mask)
    else:
        err = LIBRARY.load().flash_attention_launch(*ptrs, B, H, KV, Sq, Sk, hd, *mask)
    check_launch(err, "flash_attention")
    flash_attention.launches += 1
    if r.kernel == "mma":
        flash_attention.tc_launches += 1
    return out[..., :hd] if r.padded_copy else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None):
    """(dq, dk, dv) like q, k and v: the backward of ``flash_attention``
    from its output, its lse (``flash_attention_fwd``) and the output's
    gradient.  CUDA tensors launch ``csrc/flashattn_bwd.cu`` (Sq == Sk;
    bf16 on the tensor cores, f32 on the FP32 pipes; any strides) or
    raise; CPU tensors take ``ref.flash_attention_bwd_ref``."""
    _check(q, k, v, window)
    B, H, S, hd = q.shape
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, H, S):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} or lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    if k.shape[2] != S:
        raise ValueError(f"flash_attention_bwd kernel takes Sq == Sk, got {S} and {k.shape[2]}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd kernel takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bwd kernel takes float32 or bfloat16, got {q.dtype}")
    return _launch_bwd(q, k, v, out, lse, dout.to(q.dtype), causal, window)


def _launch_bwd(q, k, v, out, lse, dout, causal, window):
    """One backward call (three launches) on the kernels ``route`` picks."""
    B, H, S, hd = q.shape
    r = route(q, k, v, out, dout)
    ops = bwd_operands(r, q, k, v, out, dout)
    lse = lse.to(torch.float32).contiguous()
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    grads = tuple(torch.empty_like(t) for t in ops[:3])
    tensors = (*ops, *grads)
    strides = (ctypes.c_longlong * 24)(*[s for t in tensors for s in t.stride()[:3]])
    args = (*(t.data_ptr() for t in ops), lse.data_ptr(), D.data_ptr(),
            *(t.data_ptr() for t in grads), strides, B, H, k.shape[1], S, ops[0].shape[-1])
    tail = (int(causal), window or 0, softmax_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if r.kernel == "mma":
        err = BWD_LIBRARY.load().flash_attention_bwd_tc_launch(*args, r.hd_pad, *tail)
    else:
        err = BWD_LIBRARY.load().flash_attention_bwd_launch(*args, *tail)
    check_launch(err, "flash_attention_bwd")
    flash_attention.bwd_launches += BWD_KERNELS
    if r.kernel == "mma":
        flash_attention.bwd_tc_launches += BWD_TC_KERNELS
    if r.padded_copy:        # back to head_dim and the operands' layout
        return tuple(torch.empty_like(t).copy_(gr[..., :hd]) for t, gr in zip((q, k, v), grads))
    return grads


def bwd_operands(r: Route, q, k, v, out, dout) -> tuple:
    """q, k, v, out and dout as the backward kernel of route ``r`` takes
    them: zero-padded contiguous (..., roundup(hd, 8)) copies when ``r``
    says so, else each with its last dimension made contiguous."""
    if r.padded_copy:
        return tuple(_padded(t, _round_up(t.shape[-1], 8)) for t in (q, k, v, out, dout))
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, out, dout))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward, BHSD: the forward kernel writes
    each row's lse, and q, k, v, the output and lse are saved for the
    backward kernel.  ``FlashAttention.apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
        return dq, dk, dv, None, None


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_tc_launches = 0
