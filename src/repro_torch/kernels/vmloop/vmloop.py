"""The vmloop CUDA kernel: build, bind and launch.

Replaces the TPU kernel ``vmloop_call`` of the JAX package
(``src/repro/kernels/vmloop/vmloop.py``, ``pl.pallas_call``).  The kernel
source is ``csrc/vmloop.cu`` over the op bodies of ``csrc/vmloop_core.h``:
one CUDA thread per node, the stacked state updated in place in device
memory (see the note at the top of ``vmloop.cu`` for what bounds it).

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` turns
the sources under ``csrc/`` into a shared library with a plain C interface
in ``build/repro_torch/`` at the root of the checkout (the file name
carries a hash of the sources, so an edited source is rebuilt), and
``ctypes`` loads it.

No fallback hides the device: a CUDA tensor goes to the kernel, and a
failed build or launch raises.  Only CPU tensors take the plain version
(``ref.run_core``).  ``vmloop_call.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import ISA
from repro_torch.kernels.vmloop.ref import (
    CORE_FIELDS,
    CoreState,
    Tables,
    device_tables,
    run_core,
)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("vmloop_core.h", "vmloop.cu")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
MAX_VEC = 64            # rexavm::MAX_VEC in vmloop_core.h
BLOCK = 32              # threads (= nodes) per block

_LIB = None
_TABLES: dict = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused the kernel source."""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/vmloop.cu`` for sm_90a into ``build/repro_torch/`` (a
    no-op when the library for these sources exists).  Returns its path;
    ``build.seconds`` is the time the last compile took (0 when cached) and
    ``build.log`` the compiler's ``-Xptxas -v`` report."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"libvmloop_{digest.hexdigest()[:16]}.so"
    build.seconds = 0.0
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
        "-o", str(tmp), str(CSRC / "vmloop.cu"),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build.seconds = time.perf_counter() - t0
    build.log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed ({proc.returncode}):\n{build.log}")
    if verbose:
        print(build.log)
    os.replace(tmp, lib)
    return lib


build.seconds = 0.0
build.log = ""


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.vmloop_launch
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
    lib = _library()
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
    if err != 0:
        raise RuntimeError(f"vmloop kernel launch failed: CUDA error {err}")
    vmloop_call.launches += 1
    return core, n_exec, bailed, bail_op


vmloop_call.launches = 0
