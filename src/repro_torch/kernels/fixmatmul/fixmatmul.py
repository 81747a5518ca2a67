"""The fixmatmul CUDA kernels: plan, build, bind and launch.

Replaces the TPU kernel ``fixmatmul`` of the JAX package
(``src/repro/kernels/fixmatmul/fixmatmul.py``, ``pl.pallas_call``).  The
source is ``csrc/fixmatmul.cu`` (see the note at its top for what bounds
it), built by ``LIBRARY`` (``kernels/nvcc.py``) with nvcc for sm_90a at
first use and loaded with ``ctypes``.  It holds two kernels, and ``plan``
picks one by M: the streaming kernel for M <= 16 (every decode batch; one
launch, the K splits of a column tile added in a thread-block cluster) and
the tiled kernel above (K splits added by a second launch).

A CUDA tensor launches a kernel, and a failed build or launch raises;
only CPU tensors take the plain version (``ref.fixmatmul_ref``).
``fixmatmul.launches`` counts calls that launched.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref
from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.nvcc import CudaLibrary, check_launch, sm_count

CSRC = Path(__file__).resolve().parent / "csrc"
BN, BK = 64, 64                  # tiled kernel: columns and k per block stage
ROW_GROUPS = 4                   # tiled kernel: a block holds 4 * rows_per_thread(M) rows
BLOCKS_PER_SM = 4                # tiled kernel: split K until the grid has this many blocks per SM
STREAM_MAX_M = 16                # M up to this takes the streaming kernel
STREAM_TILES = (128, 64)         # its column tiles, widest first
STREAM_K_STEP = 32               # k of one mma; its K splits are whole steps
STREAM_BLOCKS_PER_SM = 1.5       # the grid it aims for (fitted on an H100: scripts/fixmatmul_sweep.py)
MAX_CLUSTER = 8                  # K splits of one column tile: one cluster of <= 8 blocks
_KERNEL_CODE = {"tiled": 0, "stream": 1}


class Plan(NamedTuple):
    """A launch: ``kernel`` "stream" or "tiled"; ``tile`` the column tile
    (stream) or the rows per thread (tiled); ``splits`` K ranges of
    ``k_per_split`` each (grid z; the cluster size of the stream kernel)."""
    kernel: str
    tile: int
    splits: int
    k_per_split: int


def _bind(lib) -> None:
    fn = lib.fixmatmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("fixmatmul", CSRC, "fixmatmul.cu", (), _bind)


def rows_per_thread(M: int) -> int:
    """The tiled kernel's rows per thread (1, 2, 4, 8 or 16): the fewest
    whose block of 4 * rpt rows holds min(M, 64)."""
    return next(r for r in (1, 2, 4, 8, 16) if ROW_GROUPS * r >= min(M, 64))


def k_splits(M: int, K: int, N: int, sms: int) -> tuple[int, int]:
    """(splits, k_per_split) of the tiled kernel's K axis: enough blocks to
    fill ``sms`` SMs, but no more splits than keep the int32 partial sums
    (8 bytes per split per output) under a quarter of the weight bytes."""
    chunks = max(1, -(-K // BK))
    bm = ROW_GROUPS * rows_per_thread(M)
    tiles = -(-N // BN) * -(-M // bm)
    want = -(-BLOCKS_PER_SM * sms // tiles)
    cap = max(1, K // (32 * max(M, 1)))
    per = -(-chunks // max(1, min(want, cap, chunks)))
    return -(-chunks // per), per * BK


def tiled_plan(M: int, K: int, N: int, sms: int) -> Plan:
    splits, per = k_splits(M, K, N, sms)
    return Plan("tiled", rows_per_thread(M), splits, per)


def plan(M: int, K: int, N: int, sms: int) -> Plan:
    """The launch for (M, K) x (K, N) on ``sms`` SMs.  M <= 16 streams:
    the widest column tile whose tiles could fill half the SMs with 8 K
    splits (else the narrowest), and the fewest K splits (whole 32-deep
    steps, at most 8) that give 1.5 blocks an SM."""
    if M > STREAM_MAX_M:
        return tiled_plan(M, K, N, sms)
    steps = max(1, -(-K // STREAM_K_STEP))
    tile = next((t for t in STREAM_TILES if -(-N // t) * MAX_CLUSTER >= sms / 2), STREAM_TILES[-1])
    splits = min(MAX_CLUSTER, steps, math.ceil(STREAM_BLOCKS_PER_SM * sms / -(-N // tile)))
    per = -(-steps // splits)
    return Plan("stream", tile, -(-steps // per), per * STREAM_K_STEP)


def launch(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """Launch ``p`` on contiguous CUDA operands that ``fixmatmul`` has
    checked; returns the (M, N) f32 output."""
    M, K = xq.shape
    N = wq.shape[1]
    dev = xq.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    part = None
    if p.kernel == "tiled" and p.splits > 1:
        part = torch.empty((p.splits, M, N), dtype=torch.int32, device=dev)
    err = LIBRARY.load().fixmatmul_launch(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, M, K, N, _KERNEL_CODE[p.kernel], p.tile,
        p.splits, p.k_per_split, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "fixmatmul")
    fixmatmul.launches += 1
    return out


def fixmatmul(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 with per-row ``sx`` (M,)
    and per-column ``sw`` (N,) f32 scales.  CUDA tensors launch the kernel
    that ``plan`` picks (or raise); CPU tensors take the plain version."""
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
    refuse_grad("fixmatmul", sx, sw)
    if M == 0 or N == 0:
        return torch.empty((M, N), dtype=torch.float32, device=dev)
    xq, wq, sx, sw = (t.contiguous() for t in (xq, wq, sx, sw))
    return launch(xq, wq, sx, sw, plan(M, K, N, sm_count(dev)))


fixmatmul.launches = 0
