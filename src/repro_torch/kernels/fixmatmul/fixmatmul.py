"""The fixmatmul CUDA kernel: build, bind and launch.

Replaces the TPU kernel ``fixmatmul`` of the JAX package
(``src/repro/kernels/fixmatmul/fixmatmul.py``, ``pl.pallas_call``).  The
source is ``csrc/fixmatmul.cu`` (see the note at its top for what bounds
it), built by ``LIBRARY`` (``kernels/nvcc.py``) with nvcc for sm_90a at
first use and loaded with ``ctypes``.

A CUDA tensor launches the kernel, and a failed build or launch raises;
only CPU tensors take the plain version (``ref.fixmatmul_ref``).
``fixmatmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref
from repro_torch.kernels.nvcc import CudaLibrary, check_launch, sm_count

CSRC = Path(__file__).resolve().parent / "csrc"
BN, BK = 64, 64                  # columns and k per block stage in csrc/fixmatmul.cu
ROW_GROUPS = 4                   # a block holds 4 * rows_per_thread(M) rows
BLOCKS_PER_SM = 4                # split K until the grid has this many blocks per SM


def _bind(lib) -> None:
    fn = lib.fixmatmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("fixmatmul", CSRC, "fixmatmul.cu", (), _bind)


def rows_per_thread(M: int) -> int:
    """The kernel's rows per thread (1, 2, 4, 8 or 16): the fewest whose
    block of 4 * rpt rows holds min(M, 64)."""
    return next(r for r in (1, 2, 4, 8, 16) if ROW_GROUPS * r >= min(M, 64))


def k_splits(M: int, K: int, N: int, sms: int) -> tuple[int, int]:
    """(splits, k_per_split) of the grid's K axis: enough blocks to fill
    ``sms`` SMs, but no more splits than keep the int32 partial sums
    (8 bytes per split per output) under a quarter of the weight bytes."""
    chunks = max(1, -(-K // BK))
    bm = ROW_GROUPS * rows_per_thread(M)
    tiles = -(-N // BN) * -(-M // bm)
    want = -(-BLOCKS_PER_SM * sms // tiles)
    cap = max(1, K // (32 * max(M, 1)))
    per = -(-chunks // max(1, min(want, cap, chunks)))
    return -(-chunks // per), per * BK


def fixmatmul(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 with per-row ``sx`` (M,)
    and per-column ``sw`` (N,) f32 scales.  CUDA tensors launch the kernel
    (or raise); CPU tensors take the plain version."""
    M, K = xq.shape
    K2, N = wq.shape
    if K2 != K or tuple(sx.shape) != (M,) or tuple(sw.shape) != (N,):
        raise ValueError(f"fixmatmul: shapes {tuple(xq.shape)} {tuple(wq.shape)} "
                         f"{tuple(sx.shape)} {tuple(sw.shape)} do not agree")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError("fixmatmul: xq and wq must be int8")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError("fixmatmul: sx and sw must be float32")
    dev = xq.device
    if any(t.device != dev for t in (wq, sx, sw)):
        raise ValueError("fixmatmul: operands on different devices")
    if dev.type == "cpu":
        return fixmatmul_ref(xq, wq, sx, sw)
    if dev.type != "cuda":
        raise ValueError(f"fixmatmul: unsupported device {dev}")
    if M == 0 or N == 0:
        return torch.empty((M, N), dtype=torch.float32, device=dev)
    xq, wq, sx, sw = (t.contiguous() for t in (xq, wq, sx, sw))
    lib = LIBRARY.load()
    splits, per = k_splits(M, K, N, sm_count(dev))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    part = torch.empty((splits, M, N), dtype=torch.int32, device=dev) if splits > 1 else None
    err = lib.fixmatmul_launch(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, M, K, N, rows_per_thread(M), splits, per,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "fixmatmul")
    fixmatmul.launches += 1
    return out


fixmatmul.launches = 0
