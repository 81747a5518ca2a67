"""The bf16 flash attention kernels' CUDA sources run on the CPU: each is
built with g++ against a small emulation of the CUDA runtime
(``tests/cuda_emu/``: a block's threads as std::threads, ldmatrix and
mma.sync by the PTX fragment layouts) and driven through the port's own
launch wrappers (``flashattn._launch``, ``flashattn._launch_bwd``) at
small shapes, against the plain versions.  The forward
(``csrc/flashattn_tc.cu``), which the card has already held against its
plain version, checks the emulation itself: within FLASH_TOL of
max(1, max |plain|) and lse within 1e-5.  The backward
(``csrc/flashattn_bwd.cu``, both routes) is then held as the card holds it
(``tests/test_torch_cuda.py``): dq, dk and dv within 1e-2 (bf16) or 1e-4
(f32) of the plain version's largest value.  The copies run synchronously here, so this checks the kernels'
arithmetic, tiling and masks, not the timing of their cp.async ring."""

import ctypes
import hashlib
import re
import shutil
import subprocess
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flashattn import flashattn as fa
from repro_torch.kernels.flashattn.ref import flash_attention_bwd_ref, flash_attention_lse_ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _emulated(main: str) -> str:
    """``csrc/<main>`` with its shared-memory declarations and launches
    rewritten for the emulation."""
    s = (fa.CSRC / main).read_text()
    s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                  "unsigned char* smem_raw = emu::blk->smem;")
    s = s.replace("extern __shared__ float smem[];",
                  "float* smem = reinterpret_cast<float*>(emu::blk->smem);")
    return re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", s, flags=re.S)


def _build(lib, gxx: str) -> Path:
    src = _emulated(lib.main)
    digest = hashlib.sha256(src.encode() + b"".join(
        p.read_bytes() for p in sorted(EMU.iterdir()))).hexdigest()[:16]
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


class _Emulated:
    """A ``CudaLibrary`` stand-in: the g++ build of its source, bound as
    the real one binds."""

    def __init__(self, lib, path: Path):
        self.lib = ctypes.CDLL(str(path))
        lib.bind(self.lib)
        self.lib.emu_faults.restype = ctypes.c_int

    def load(self):
        return self.lib


@pytest.fixture(scope="module")
def emulated():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' sources for the CPU")
    with ThreadPoolExecutor(2) as pool:
        paths = list(pool.map(lambda lib: _build(lib, gxx), (fa.TC_LIBRARY, fa.BWD_LIBRARY)))
    return [_Emulated(lib, p) for lib, p in zip((fa.TC_LIBRARY, fa.BWD_LIBRARY), paths)]


@pytest.fixture
def kernels(emulated, monkeypatch):
    tc, bwd = emulated
    monkeypatch.setattr(fa, "TC_LIBRARY", tc)
    monkeypatch.setattr(fa, "BWD_LIBRARY", bwd)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    yield tc, bwd
    assert tc.lib.emu_faults() == 0 and bwd.lib.emu_faults() == 0


def _inputs(B, H, KV, S, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(sh, generator=g).to(dtype)
                 for sh in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (1, 2, 1, 130, 16, True, None),        # two query tiles, the second ragged
    (1, 4, 2, 200, 80, True, 50),          # danube's head_dim, a window
    (1, 2, 2, 150, 64, False, None),       # non-causal
])
def test_emulated_forward_matches_plain_version(B, H, KV, S, hd, causal, window, kernels):
    q, k, v, _ = _inputs(B, H, KV, S, hd, torch.bfloat16, S + hd)
    lse = torch.empty((B, H, S), dtype=torch.float32)
    out = fa._launch(q, k, v, causal, window, lse)
    out_r, lse_r = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    err = (out.float() - out_r.float()).abs().max() / out_r.float().abs().max().clamp(min=1)
    assert float(err) <= FLASH_TOL[torch.bfloat16]
    assert float((lse - lse_r).abs().max()) <= 1e-5 * max(1.0, float(lse_r.abs().max()))


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", [
    (1, 2, 1, 130, 16, True, None, torch.bfloat16),    # dK/dV's second key tile: 2 keys
    (2, 4, 1, 70, 8, True, 5, torch.bfloat16),         # B 2, MQA (a group of 4), window < a tile
    (1, 4, 2, 200, 80, True, 50, torch.bfloat16),      # danube's head_dim, GQA 2
    (1, 2, 2, 150, 64, False, None, torch.bfloat16),   # non-causal
    (1, 2, 1, 150, 36, True, 70, torch.bfloat16),      # hd 36: the padded copy, HD_PAD 48
    (1, 2, 1, 90, 80, True, 20, torch.float32),        # the FP32-pipe kernels
])
def test_emulated_backward_matches_plain_version(B, H, KV, S, hd, causal, window, dtype, kernels):
    q, k, v, dout = _inputs(B, H, KV, S, hd, dtype, S + hd)
    out, lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    n, tc = fa.flash_attention.bwd_launches, fa.flash_attention.bwd_tc_launches
    grads = fa._launch_bwd(q, k, v, out, lse, dout, causal, window)
    assert fa.flash_attention.bwd_launches == n + fa.BWD_KERNELS
    assert fa.flash_attention.bwd_tc_launches == \
        tc + fa.BWD_TC_KERNELS * (dtype == torch.bfloat16)
    refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, a, b, t in zip(("dq", "dk", "dv"), grads, refs, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel <= FLASH_BWD_TOL[dtype], (name, rel)
