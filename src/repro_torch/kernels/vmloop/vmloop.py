"""The vmloop CUDA kernel: build, bind and launch.

Replaces the TPU kernel ``vmloop_call`` of the JAX package
(``src/repro/kernels/vmloop/vmloop.py``, ``pl.pallas_call``).  The kernel
source is ``csrc/vmloop.cu`` over the op bodies of ``csrc/vmloop_core.h``:
one CUDA thread per node, the stacked state updated in place in device
memory (see the note at the top of ``vmloop.cu`` for what bounds it).

Build: ``LIBRARY`` (``kernels/nvcc.py``) compiles ``csrc/vmloop.cu`` with
nvcc for sm_90a at first use and loads it with ``ctypes``.

No fallback hides the device: a CUDA tensor goes to the kernel, and a
failed build or launch raises.  Only CPU tensors take the plain version
(``ref.run_core``).  ``vmloop_call.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import ISA
from repro_torch.kernels.nvcc import CudaLibrary, check_launch
from repro_torch.kernels.vmloop.ref import (
    CORE_FIELDS,
    CoreState,
    Tables,
    device_tables,
    run_core,
)

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_VEC = 64            # rexavm::MAX_VEC in vmloop_core.h
BLOCK = 32              # threads (= nodes) per block

_TABLES: dict = {}


def _bind(lib) -> None:
    fn = lib.vmloop_launch
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("vmloop", CSRC, "vmloop.cu", ("vmloop_core.h",), _bind)


def _tables(isa: ISA | None, device) -> Tables:
    key = (id(isa), str(device))
    if key not in _TABLES:
        _TABLES[key] = device_tables(isa, device)
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


def vmloop_call(core: CoreState, steps: int, cfg: VMConfig, isa: ISA | None = None):
    """Run up to ``steps`` claimed instructions per node over a stacked
    ``CoreState``, in place.  Returns ``(core, n_exec, bailed, bail_op)``,
    the last three (N,) int32 (see ``ref.run_core``).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    N = _check(core, cfg)
    dev = core.pc.device
    if dev.type == "cpu":
        return run_core(core, _tables(isa, dev), steps, cfg, isa)
    if dev.type != "cuda":
        raise ValueError(f"vmloop: unsupported device {dev}")
    lib = LIBRARY.load()
    tb = _tables(isa, dev)
    n_exec = torch.empty(N, dtype=torch.int32, device=dev)
    bailed = torch.empty(N, dtype=torch.int32, device=dev)
    bail_op = torch.empty(N, dtype=torch.int32, device=dev)
    fields = (ctypes.c_void_p * 24)(*[getattr(core, f).data_ptr() for f in CORE_FIELDS])
    tables = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in tb])
    dims = (ctypes.c_int32 * 8)(
        cfg.cs_size, cfg.mem_size, cfg.max_tasks, cfg.ds_size, cfg.rs_size,
        cfg.fs_size, cfg.out_ring_size, cfg.max_vec,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vmloop_launch(
        fields, tables, dims, N, int(steps), n_exec.data_ptr(), bailed.data_ptr(),
        bail_op.data_ptr(), stream, BLOCK,
    )
    check_launch(err, "vmloop")
    vmloop_call.launches += 1
    return core, n_exec, bailed, bail_op


vmloop_call.launches = 0
