"""Build a kernel's CUDA source with g++ against the emulation headers of
this directory and bind it as its ``CudaLibrary`` binds the nvcc build
(the emulation tests, ``tests/test_torch_*_emu.py``, import this)."""

import ctypes
import hashlib
import re
import subprocess
from pathlib import Path

EMU = Path(__file__).resolve().parent
ROOT = EMU.parents[1]


def emulated(lib) -> str:
    """``lib``'s main source with its shared-memory declarations and
    launches rewritten for the emulation."""
    s = (lib.csrc / lib.main).read_text()
    s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                  "unsigned char* smem_raw = emu::blk->smem;")
    s = s.replace("extern __shared__ float smem[];",
                  "float* smem = reinterpret_cast<float*>(emu::blk->smem);")
    return re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", s, flags=re.S)


def build(lib, gxx: str) -> Path:
    """The g++ build of ``lib``'s source under ``build/repro_torch_test/``,
    named by a hash of the rewritten source and the headers."""
    src = emulated(lib)
    digest = hashlib.sha256(src.encode() + b"".join(
        p.read_bytes() for p in sorted(EMU.iterdir()) if p.suffix in (".h", ".cuh"))).hexdigest()[:16]
    out = ROOT / "build" / "repro_torch_test" / f"lib{lib.name}_emu_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cpp = out.with_suffix(".cpp")
        cpp.write_text(src)
        tmp = out.with_suffix(f".{digest}.tmp")
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(EMU),
                        "-o", str(tmp), str(cpp)], check=True, capture_output=True, text=True)
        tmp.replace(out)
    return out


class Emulated:
    """A ``CudaLibrary`` stand-in: the g++ build of its source, bound as
    the real one binds."""

    def __init__(self, lib, path: Path):
        self.lib = ctypes.CDLL(str(path))
        lib.bind(self.lib)
        self.lib.emu_faults.restype = ctypes.c_int

    def load(self):
        return self.lib
