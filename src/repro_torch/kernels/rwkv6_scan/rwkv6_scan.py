"""The rwkv6_scan CUDA kernels: build, bind and launch.

Replace the TPU kernel ``rwkv6_scan`` of the JAX package
(``src/repro/kernels/rwkv6_scan/rwkv6_scan.py``, ``pl.pallas_call``).  The
source is ``csrc/rwkv6_scan.cu`` (see the note at its top for what bounds
each kernel), built by ``LIBRARY`` (``kernels/nvcc.py``) with nvcc for
sm_90a at first use and loaded with ``ctypes``.  ``route`` picks by the
number of steps and chunks:

  "decode"    — one step (S = 1, the decode step): tiles of the state's
                columns, launched as a programmatic dependent;
  "one_block" — one chunk of 1 < S <= chunk: one block per (batch, head);
  "chunked"   — two or more (the prefill): a state pass over tiles of the
                state's rows that stores each chunk's start state in an
                f32 scratch, then an output pass with one block per chunk.

A CUDA tensor launches a kernel, and a failed build or launch raises;
only CPU tensors take the plain version (``ref.rwkv6_scan_ref``).
``rwkv6_scan.launches`` counts calls that launched (one a call, any
route), ``rwkv6_scan.chunked_launches`` those that took the two passes
and ``rwkv6_scan.decode_launches`` those that took the decode kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.nvcc import CudaLibrary, check_launch
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_K = 64                       # head size and chunk length the kernel's shared memory holds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("decode", "one_block", "chunked")


def _bind(lib) -> None:
    for name, n_ptrs in (("rwkv6_scan_launch", 8), ("rwkv6_scan_chunked_launch", 9),
                         ("rwkv6_scan_decode_launch", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("rwkv6_scan", CSRC, "rwkv6_scan.cu", (), _bind)


def route(S: int, chunk: int = 64) -> str:
    """The kernel a call of ``S`` steps takes: "decode" for one step,
    "chunked" when it holds two or more chunks of L = min(chunk, S), else
    "one_block"."""
    if S == 1:
        return "decode"
    return "chunked" if S >= 2 * min(chunk, S) else "one_block"


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, state0: torch.Tensor, *, chunk: int = 64,
               state_out: torch.Tensor | None = None,
               kernel: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 WKV over chunks of L = min(chunk, S).

    r, k, v (B, H, S, K) in one dtype (f32 or bf16), logw (B, H, S, K) f32
    (<= 0), u (H, K) f32, state0 (B, H, K, K) f32; any strides with K
    contiguous.  Returns (out (B, H, S, K) in r's dtype, the new state).
    The new state goes into ``state_out`` when it is given, which may be
    ``state0`` itself (in place).  CUDA tensors launch the kernel that
    ``route`` picks, or ``kernel`` (one of ``ROUTES``; "decode" only at
    S = 1) when it is given, so that a test or a timing can hold them
    against each other; they raise on failure.  CPU tensors take the plain
    version whatever ``kernel`` says."""
    B, H, S, K = r.shape
    if any(tuple(t.shape) != (B, H, S, K) for t in (k, v, logw)) or tuple(u.shape) != (H, K) \
            or tuple(state0.shape) != (B, H, K, K):
        raise ValueError(f"rwkv6_scan: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} logw {tuple(logw.shape)} u {tuple(u.shape)} "
                         f"state0 {tuple(state0.shape)} do not agree")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"rwkv6_scan: seq {S} is not a positive multiple of the chunk {L}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("rwkv6_scan: r, k and v must share one dtype")
    if any(t.dtype != torch.float32 for t in (logw, u, state0)):
        raise ValueError("rwkv6_scan: logw, u and state0 must be float32")
    if state_out is not None and (tuple(state_out.shape) != (B, H, K, K)
                                  or state_out.dtype != torch.float32):
        raise ValueError("rwkv6_scan: state_out must be (B, H, K, K) float32")
    if kernel is not None and kernel not in ROUTES:
        raise ValueError(f"rwkv6_scan: kernel must be one of {ROUTES}, got {kernel!r}")
    dev = r.device
    if any(t.device != dev for t in (k, v, logw, u, state0)) or (
            state_out is not None and state_out.device != dev):
        raise ValueError("rwkv6_scan: operands on different devices")
    if dev.type == "cpu":
        out, s1 = rwkv6_scan_ref(r, k, v, logw, u, state0, chunk=chunk)
        if state_out is not None:
            s1 = state_out.copy_(s1)
        return out.to(r.dtype), s1
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {dev}")
    refuse_grad("rwkv6_scan", r, k, v, logw, u, state0)
    if r.dtype not in _DTYPE_CODE:
        raise ValueError(f"rwkv6_scan kernel takes float32 or bfloat16, got {r.dtype}")
    if K > MAX_K or L > MAX_K:
        raise ValueError(f"rwkv6_scan kernel takes head size and chunk <= {MAX_K}, "
                         f"got {K} and {L}")
    if state_out is not None and not state_out.is_contiguous():
        raise ValueError("rwkv6_scan: state_out must be contiguous")
    kern = kernel or route(S, chunk)
    if kern == "decode" and S != 1:
        raise ValueError(f"rwkv6_scan: the decode kernel takes one step, got {S}")
    r, k, v, logw = (t if t.stride(-1) == 1 else t.contiguous() for t in (r, k, v, logw))
    u, state0 = u.contiguous(), state0.contiguous()
    lib = LIBRARY.load()
    out = torch.empty((B, S, H, K), dtype=r.dtype, device=dev).movedim(2, 1)
    s1 = state_out if state_out is not None else torch.empty_like(state0)
    strides = (ctypes.c_longlong * 15)(*[s for t in (r, k, v, logw, out) for s in t.stride()[:3]])
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            state0.data_ptr(), out.data_ptr(), s1.data_ptr())
    tail = (B, H, S, K, L, _DTYPE_CODE[r.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if kern == "chunked":
        kp = -(-K // 4) * 4
        # the state each chunk starts from (134 MB at B 1, H 64, S 8192, K 64)
        scratch = torch.empty((B, H, S // L, kp, kp), dtype=torch.float32, device=dev)
        err = lib.rwkv6_scan_chunked_launch(*ptrs, scratch.data_ptr(), strides, *tail)
    elif kern == "decode":
        err = lib.rwkv6_scan_decode_launch(*ptrs, strides, *tail)
    else:
        err = lib.rwkv6_scan_launch(*ptrs, strides, *tail)
    check_launch(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    rwkv6_scan.chunked_launches += kern == "chunked"
    rwkv6_scan.decode_launches += kern == "decode"
    return out, s1


rwkv6_scan.launches = 0
rwkv6_scan.chunked_launches = 0
rwkv6_scan.decode_launches = 0
