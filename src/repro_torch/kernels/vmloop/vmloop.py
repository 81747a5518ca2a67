"""The vmloop CUDA kernel: build, bind and launch.

Replaces the TPU kernel ``vmloop_call`` of the JAX package
(``src/repro/kernels/vmloop/vmloop.py``, ``pl.pallas_call``).  The kernel
source is ``csrc/vmloop.cu`` over the op bodies of ``csrc/vmloop_core.h``:
one CUDA thread per node, 1-32 nodes a block, the current task's scalars
in registers (see the note at the top of ``vmloop.cu`` for the design,
what was tried and dropped, and what bounds it).

Build: ``LIBRARY`` (``kernels/nvcc.py``) compiles ``csrc/vmloop.cu`` with
nvcc for sm_90a at first use and loads it with ``ctypes``.  It holds two
instances of the kernel: the default one and the counting one
(``obs=True``, the reference's ``vmloop_call(obs=True)``), which also
returns each row's retirement histogram.

No fallback hides the device: a CUDA tensor goes to the kernel, and a
failed build or launch raises.  Only CPU tensors take the plain version
(``ref.run_core``).  ``vmloop_call.launches`` counts kernel launches of
either instance, ``vmloop_call.obs_launches`` those of the counting one.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import ISA
from repro_torch.kernels.nvcc import CudaLibrary, check_launch, sm_count
from repro_torch.kernels.vmloop.ref import (
    CORE_FIELDS,
    CoreState,
    Tables,
    device_tables,
    make_tables,
    run_core,
)

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_VEC = 64            # rexavm::MAX_VEC in vmloop_core.h
NUM_OPS = 99            # rexavm::NUM_OPS: the tables hold NUM_OPS + 1 entries
MAX_BLOCK = 32          # nodes a block at most
BLOCKS_PER_SM = 4       # blocks an SM that nodes_per_block aims at

_TABLES: dict = {}


def _bind(lib) -> None:
    head = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.vmloop_launch.argtypes = head + [ctypes.c_void_p, ctypes.c_int32]
    lib.vmloop_obs_launch.argtypes = head + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    for fn in (lib.vmloop_launch, lib.vmloop_obs_launch):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("vmloop", CSRC, "vmloop.cu", ("vmloop_core.h",), _bind)


def pack_meta(tb: Tables) -> np.ndarray:
    """Each opcode's claim bit and stack effect in one int32 word: bit 0
    claimed, then din, dout, fin, fout in 7-bit fields (the kernel's
    ``meta_*``)."""
    if len(tb.sup) != NUM_OPS + 1:
        raise ValueError(f"vmloop kernel takes {NUM_OPS} opcodes, the ISA has {len(tb.sup) - 1}")
    effects = np.stack([tb.din, tb.dout, tb.fin, tb.fout]).astype(np.int64)
    if effects.min() < 0 or effects.max() > 127:
        raise ValueError("vmloop kernel packs stack effects into 7 bits: each must be in [0, 127]")
    return ((np.asarray(tb.sup) != 0) | effects[0] << 1 | effects[1] << 8 | effects[2] << 15
            | effects[3] << 22).astype(np.int32)


def _tables(isa: ISA | None, device) -> tuple[Tables, torch.Tensor]:
    """The constant tables and the packed opcode table on ``device``."""
    key = (id(isa), str(device))
    if key not in _TABLES:
        meta = torch.as_tensor(pack_meta(make_tables(isa)), device=device)
        _TABLES[key] = (device_tables(isa, device), meta)
    return _TABLES[key]


def _check(core: CoreState, cfg: VMConfig) -> int:
    N = core.pc.shape[0]
    T = cfg.max_tasks
    shapes = {
        "cs": (N, cfg.cs_size), "mem": (N, cfg.mem_size),
        "ds": (N, T, cfg.ds_size), "rs": (N, T, cfg.rs_size), "fs": (N, T, cfg.fs_size),
        "handlers": (N, 9), "out": (N, 2 * cfg.out_ring_size),
        "cur": (N,), "now": (N,), "steps": (N,), "outp": (N,),
    }
    dev = core.pc.device
    for f in CORE_FIELDS:
        x = getattr(core, f)
        want = shapes.get(f, (N, T))
        if tuple(x.shape) != want:
            raise ValueError(f"vmloop: field {f} has shape {tuple(x.shape)}, expected {want}")
        if x.dtype != torch.int32 or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"vmloop: field {f} must be contiguous int32 on {dev}")
    if cfg.max_vec > MAX_VEC:
        raise ValueError(f"vmloop kernel takes max_vec <= {MAX_VEC}, got {cfg.max_vec}")
    return N


def _check_rows(x, name: str, n: int | None, dev) -> int:
    """A row list or budget: (R,) contiguous int32 on the state's device."""
    if x is None:
        return -1
    if not isinstance(x, torch.Tensor) or x.dim() != 1 or (n is not None and x.shape[0] != n):
        want = f"({n},)" if n is not None else "(R,)"
        raise ValueError(f"vmloop: {name} must be a {want} tensor")
    if x.dtype != torch.int32 or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"vmloop: {name} must be contiguous int32 on {dev}")
    return x.shape[0]


def nodes_per_block(rows: int, sms: int) -> int:
    """Nodes a block from the rows of a launch and the SM count: up to
    BLOCKS_PER_SM blocks an SM while the rows allow
    (ceil(rows / (BLOCKS_PER_SM * sms)), in 1..32), so that each SM has
    several nodes' chains to interleave and a small fleet runs one node a
    block on as many SMs as it has nodes."""
    return max(1, min(MAX_BLOCK, -(-rows // (BLOCKS_PER_SM * max(sms, 1)))))


def _dims(cfg: VMConfig):
    return (ctypes.c_int32 * 8)(
        cfg.cs_size, cfg.mem_size, cfg.max_tasks, cfg.ds_size, cfg.rs_size,
        cfg.fs_size, cfg.out_ring_size, cfg.max_vec,
    )


def vmloop_call(core: CoreState, steps: int, cfg: VMConfig, isa: ISA | None = None,
                rows: torch.Tensor | None = None, budget: torch.Tensor | None = None,
                obs: bool = False):
    """Run claimed instructions over a stacked ``CoreState``, in place, and
    return ``(core, n_exec, bailed, bail_op)``, the last three (R,) int32
    (see ``ref.run_core``).

    Without ``rows`` every node runs (R = N, row j is node j); with it, only
    nodes ``rows`` (distinct), in that order.  Row j runs up to
    ``budget[j]`` instructions, or ``steps`` without a budget.

    ``obs=True`` launches the counting instance, which also returns
    ``op_hist`` (R, num_ops + 4) int32: row j's retired instructions by bin
    (``ref.run_core(obs=True)``).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    N = _check(core, cfg)
    dev = core.pc.device
    R = _check_rows(rows, "rows", None, dev)
    R = N if R < 0 else R
    _check_rows(budget, "budget", R, dev)
    if dev.type == "cpu":
        return run_core(core, _tables(isa, dev)[0], steps, cfg, isa, rows=rows, budget=budget,
                        obs=obs)
    if dev.type != "cuda":
        raise ValueError(f"vmloop: unsupported device {dev}")
    lib = LIBRARY.load()
    tb, meta = _tables(isa, dev)
    block = nodes_per_block(R, sm_count(dev))
    n_exec = torch.empty(R, dtype=torch.int32, device=dev)
    bailed = torch.empty(R, dtype=torch.int32, device=dev)
    bail_op = torch.empty(R, dtype=torch.int32, device=dev)
    op_hist = torch.empty((R, NUM_OPS + 4), dtype=torch.int32, device=dev) if obs else None
    out = (core, n_exec, bailed, bail_op) + ((op_hist,) if obs else ())
    if R == 0:
        return out
    fields = (ctypes.c_void_p * 24)(*[getattr(core, f).data_ptr() for f in CORE_FIELDS])
    tables = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in tb])
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (fields, tables, meta.data_ptr(), _dims(cfg), N, int(steps),
            None if rows is None else rows.data_ptr(),
            None if budget is None else budget.data_ptr(), R,
            n_exec.data_ptr(), bailed.data_ptr(), bail_op.data_ptr())
    if obs:
        err = lib.vmloop_obs_launch(*args, op_hist.data_ptr(), stream, block)
        check_launch(err, "vmloop (counting instance)")
        vmloop_call.obs_launches += 1
    else:
        err = lib.vmloop_launch(*args, stream, block)
        check_launch(err, "vmloop")
    vmloop_call.launches += 1
    return out


vmloop_call.launches = 0
vmloop_call.obs_launches = 0
