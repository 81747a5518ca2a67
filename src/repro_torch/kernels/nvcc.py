"""Build a kernel's CUDA sources with nvcc and load them with ctypes.

Every kernel of the port is CUDA C++ for Hopper under its ``csrc/``,
compiled at first use by ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface in ``build/repro_torch/`` at
the root of the checkout.  The file name carries a hash of the sources, so
an edited source is rebuilt.  Nothing is built when a module is imported:
the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """One kernel's shared library: ``csrc/<main>`` plus the headers it
    includes, built for sm_90a and bound by ``bind(lib)``, which sets the
    ``argtypes``/``restype`` of its C functions.

    ``build()`` compiles (a no-op when the library for these sources
    exists); ``seconds`` is the time this process's compile took (0 when
    it found the library built) and ``log`` the compiler's ``-Xptxas -v``
    report.  ``load()`` builds if needed and returns the bound
    ``ctypes.CDLL``."""

    def __init__(self, name: str, csrc: Path, main: str, headers: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.csrc = csrc
        self.main = main
        self.sources = (*headers, main)
        self.bind = bind
        self.seconds = 0.0
        self.log = ""
        self._lib = None

    def path(self) -> Path:
        digest = hashlib.sha256()
        for name in self.sources:
            digest.update((self.csrc / name).read_bytes())
        return BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        lib = self.path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(self.csrc),
            "-o", str(tmp), str(self.csrc / self.main),
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.seconds = time.perf_counter() - t0
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed on {self.main} ({proc.returncode}):\n{self.log}")
        os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self.bind(lib)
            self._lib = lib
        return self._lib

    def ptxas_lines(self) -> list[str]:
        """The function, register, shared-memory, stack and spill lines of
        the last compile's ``-Xptxas -v`` report."""
        keys = ("Function properties", "registers", "stack frame", "spill")
        return [ln.strip() for ln in self.log.splitlines() if any(k in ln for k in keys)]


_SMS: dict = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA ``device`` (cached)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
