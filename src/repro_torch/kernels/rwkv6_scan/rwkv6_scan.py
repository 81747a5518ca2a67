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

The backward (``csrc/rwkv6_scan_bwd.cu`` with ``csrc/rwkv6_mma.cuh``,
built by ``BWD_LIBRARY``) is ``rwkv6_scan_bwd``: a dstate pass over the
chunks in reverse, then a gradient pass with one block per chunk, from the
state each chunk starts from, which the forward's chunked route keeps in
its scratch (one chunk: ``state0``); bf16 runs both on the tensor cores
(``rwkv6_scan.bwd_tc_launches`` counts them), f32 on the FP32 pipes.
``RwkvScan`` is the autograd function that runs the forward kernel, keeps
those states and runs the backward kernels, and ``ops.wkv`` takes it on
CUDA when an input requires grad; ``rwkv6_scan`` itself still refuses
such inputs.
``rwkv6_scan.bwd_launches`` counts the backward's kernel launches,
``BWD_KERNELS`` a call.  CPU tensors take the plain passes
(``ref.chunk_dstates_ref``, ``ref.chunk_grads_ref``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.nvcc import CudaLibrary, check_launch
from repro_torch.kernels.rwkv6_scan.ref import (
    chunk_dstates_ref,
    chunk_grads_ref,
    chunk_outputs_ref,
    chunk_states_ref,
    rwkv6_scan_ref,
)

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


def _bind_bwd(lib) -> None:
    fn = lib.rwkv6_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rwkv6_scan_bwd_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rwkv6_scan_bwd_occupancy.restype = ctypes.c_int


LIBRARY = CudaLibrary("rwkv6_scan", CSRC, "rwkv6_scan.cu", (), _bind)
BWD_LIBRARY = CudaLibrary("rwkv6_scan_bwd", CSRC, "rwkv6_scan_bwd.cu",
                          ("rwkv6_mma.cuh", "../../flashattn/csrc/flashattn_mma.cuh"), _bind_bwd)
BWD_KERNELS = 2                  # the dstate pass and the gradient pass: one backward call
BWD_TC_KERNELS = 2               # of which on the tensor cores, in bf16
OCCUPANCY = ("grad_tc", "dstate_tc", "grad_f32", "dstate_f32")


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
    _check(r, k, v, logw, u, state0, chunk, state_out, kernel)
    if r.device.type == "cpu":
        out, s1 = rwkv6_scan_ref(r, k, v, logw, u, state0, chunk=chunk)
        if state_out is not None:
            s1 = state_out.copy_(s1)
        return out.to(r.dtype), s1
    refuse_grad("rwkv6_scan", r, k, v, logw, u, state0)
    return _launch(r, k, v, logw, u, state0, chunk, state_out, kernel)[:2]


def _check(r, k, v, logw, u, state0, chunk, state_out=None, kernel=None) -> None:
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv6_scan: unsupported device {dev}")


def _kp(K: int) -> int:
    """The pitch of a state in the chunked route's scratch: K rounded up to
    a multiple of 4."""
    return -(-K // 4) * 4


def _launch(r, k, v, logw, u, state0, chunk, state_out=None, kernel=None,
            keep_states: bool = False):
    """(out, s1, states) on the kernel ``route`` picks (or ``kernel``);
    ``states`` (B, H, S // L, Kp, Kp) f32, the state each chunk starts
    from, when ``keep_states`` (the chunked route's scratch; one chunk:
    ``state0``, zero-padded to Kp), else None."""
    B, H, S, K = r.shape
    L = min(chunk, S)
    dev = r.device
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
    kp, states = _kp(K), None
    if kern == "chunked":
        # the state each chunk starts from (134 MB at B 1, H 64, S 8192, K 64)
        states = torch.empty((B, H, S // L, kp, kp), dtype=torch.float32, device=dev)
        err = lib.rwkv6_scan_chunked_launch(*ptrs, states.data_ptr(), strides, *tail)
    else:
        if keep_states:
            states = state0.new_zeros((B, H, 1, kp, kp))
            states[:, :, 0, :K, :K] = state0
        if kern == "decode":
            err = lib.rwkv6_scan_decode_launch(*ptrs, strides, *tail)
        else:
            err = lib.rwkv6_scan_launch(*ptrs, strides, *tail)
    check_launch(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    rwkv6_scan.chunked_launches += kern == "chunked"
    rwkv6_scan.decode_launches += kern == "decode"
    return out, s1, states


def rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1, *, chunk: int = 64):
    """The gradients of ``rwkv6_scan``'s (out, s1) against (dout, ds1):
    (dr, dk, dv in r's dtype, dlogw (B, H, S, K) f32, du (H, K) f32,
    dstate0 (B, H, K, K) f32).  ``states`` (B, H, S // L, >= K, >= K) f32
    holds the state each chunk of L = min(chunk, S) starts from (its
    leading K x K block).  CUDA tensors launch ``csrc/rwkv6_scan_bwd.cu``
    (``states`` as ``_launch`` keeps them) or raise; CPU tensors take the
    plain passes."""
    B, H, S, K = r.shape
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"rwkv6_scan_bwd: seq {S} is not a positive multiple of the chunk {L}")
    if tuple(dout.shape) != (B, H, S, K) or tuple(ds1.shape) != (B, H, K, K) \
            or tuple(states.shape[:3]) != (B, H, S // L) or states.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan_bwd: dout {tuple(dout.shape)}, ds1 {tuple(ds1.shape)} or "
                         f"states {tuple(states.shape)} do not fit r {tuple(r.shape)}")
    if r.device.type == "cpu":
        dstates, ds0 = chunk_dstates_ref(r, logw, dout, ds1, chunk=chunk)
        dr, dk, dv, dw, du = chunk_grads_ref(r, k, v, logw, u, states[..., :K, :K], dout,
                                             dstates, chunk=chunk)
        return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du.sum((0, 1)), ds0
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    if r.dtype not in _DTYPE_CODE or K > MAX_K or L > MAX_K:
        raise ValueError(f"rwkv6_scan_bwd kernel takes float32 or bfloat16 and head size and "
                         f"chunk <= {MAX_K}, got {r.dtype}, {K} and {L}")
    if tuple(states.shape[3:]) != (_kp(K), _kp(K)):
        raise ValueError(f"rwkv6_scan_bwd kernel takes states of pitch {_kp(K)}, got "
                         f"{tuple(states.shape)}")
    return _launch_bwd(r, k, v, logw, u, states, dout.to(r.dtype), ds1, L)


def _launch_bwd(r, k, v, logw, u, states, dout, ds1, L):
    """One backward call (``BWD_KERNELS`` launches; bf16 on the tensor
    cores, counted by ``bwd_tc_launches`` too)."""
    B, H, S, K = r.shape
    dev = r.device
    r, k, v, logw, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (r, k, v, logw, dout))
    u, states = u.to(torch.float32).contiguous(), states.contiguous()
    ds1 = ds1.to(torch.float32).contiguous()
    grads = [torch.empty((B, S, H, K), dtype=dt, device=dev).movedim(2, 1)
             for dt in (r.dtype, r.dtype, r.dtype, torch.float32)]
    du_part = torch.empty((B, S // L, H, K), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    dstates = torch.empty_like(states)
    tensors = (r, k, v, logw, dout, *grads)
    strides = (ctypes.c_longlong * 27)(*[s for t in tensors for s in t.stride()[:3]])
    ptrs = [t.data_ptr() for t in (r, k, v, logw, u, states, dout, ds1, *grads, du_part, ds0,
                                   dstates)]
    err = BWD_LIBRARY.load().rwkv6_scan_bwd_launch(
        *ptrs, strides, B, H, S, K, L, _DTYPE_CODE[r.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "rwkv6_scan_bwd")
    rwkv6_scan.bwd_launches += BWD_KERNELS
    rwkv6_scan.bwd_tc_launches += BWD_TC_KERNELS if r.dtype == torch.bfloat16 else 0
    return (*grads, du_part.sum((0, 1)), ds0)


def bwd_occupancy() -> dict:
    """Resident blocks an SM of each backward kernel on the current device
    (``OCCUPANCY`` names them), from the CUDA occupancy API."""
    out = (ctypes.c_int * len(OCCUPANCY))()
    check_launch(BWD_LIBRARY.load().rwkv6_scan_bwd_occupancy(out), "rwkv6_scan_bwd occupancy")
    return dict(zip(OCCUPANCY, out))


class RwkvScan(torch.autograd.Function):
    """rwkv6_scan with its backward, (B, H, S, K): the forward kernel keeps
    the state each chunk starts from, which the backward kernels read.
    ``RwkvScan.apply(r, k, v, logw, u, state0, chunk)`` -> (out, s1).  CPU
    tensors take the plain state and output passes forward and the plain
    backward passes."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, chunk):
        _check(r, k, v, logw, u, state0, chunk)
        if r.device.type == "cpu":
            states, s1 = chunk_states_ref(k, v, logw, state0, chunk=chunk)
            out = chunk_outputs_ref(r, k, v, logw, u, states, chunk=chunk).to(r.dtype)
        else:
            out, s1, states = _launch(r, k, v, logw, u, state0, chunk, keep_states=True)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.chunk = chunk
        return out, s1

    @staticmethod
    def backward(ctx, dout, ds1):
        r, k, v, logw, u, states = ctx.saved_tensors
        grads = rwkv6_scan_bwd(r, k, v, logw, u, states, dout, ds1, chunk=ctx.chunk)
        return (*grads, None)


rwkv6_scan.launches = 0
rwkv6_scan.chunked_launches = 0
rwkv6_scan.decode_launches = 0
rwkv6_scan.bwd_launches = 0
rwkv6_scan.bwd_tc_launches = 0
