"""rwkv6_scan's backward kernels (``csrc/rwkv6_scan_bwd.cu``) run on the
CPU: the source is built with g++ against the emulation of the CUDA
runtime in ``tests/cuda_emu/`` (a block's threads as std::threads, warp
shuffles through a per-warp buffer; for the bf16 tensor-core kernels,
``rwkv6_mma.cuh``: ldmatrix and mma.sync by the PTX fragment layouts, the
exact three-way split of an f32 into bf16 parts) and driven through the
port's own launch wrapper ``rwkv6_scan._launch_bwd`` at small shapes, from the
states the plain state pass gives, against the plain backward passes
(``ref.rwkv6_scan_bwd_ref``): every gradient within 1e-4 (f32) or 1e-2
(bf16) of the plain version's largest value, as the card holds it
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 10), and the f32
gradients (dlogw, du, dstate0) within 1e-4 in either instance."""

import importlib
import shutil
import types

import pytest
import torch
from cuda_emu.emulate import Emulated, build

from repro_torch.kernels.rwkv6_scan.ref import chunk_states_ref, rwkv6_scan_bwd_ref

rmod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")

torch.set_num_threads(1)

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


@pytest.fixture(scope="module")
def emulated():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the CPU")
    return Emulated(rmod.BWD_LIBRARY, build(rmod.BWD_LIBRARY, gxx))


@pytest.fixture
def kernel(emulated, monkeypatch):
    monkeypatch.setattr(rmod, "BWD_LIBRARY", emulated)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    yield emulated
    assert emulated.lib.emu_faults() == 0


def _inputs(B, H, S, K, dtype, decay, seed):
    """r, k, v, dout (dtype), logw, u, state0 and d(s1) (f32), with numpy
    draws from ``seed``; ``decay="fast"`` passes the clip at -60 within a
    chunk of 32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.tensor(rng.standard_normal(shape) * scale,
                                               dtype=torch.float32)
    r, k, v = (t(B, H, S, K, scale=0.5).to(dtype) for _ in range(3))
    lo, hi = (-6.0, -4.0) if decay == "slow" else (-1.0, 2.0)
    logw = -torch.exp(torch.tensor(rng.uniform(lo, hi, (B, H, S, K)), dtype=torch.float32))
    return r, k, v, t(B, H, S, K).to(dtype), logw, t(H, K, scale=0.5), t(B, H, K, K, scale=0.1), \
        t(B, H, K, K)


@pytest.mark.parametrize("B,H,S,K,L,dtype,decay", [
    (1, 1, 16, 16, 16, torch.float32, "slow"),      # one chunk
    (1, 1, 48, 16, 16, torch.float32, "slow"),      # three chunks
    (1, 1, 64, 64, 64, torch.float32, "slow"),      # the model's head size and chunk
    (2, 1, 32, 20, 32, torch.float32, "fast"),      # K 20 (a last row tile of 4), B 2, the clip
    (1, 1, 48, 16, 16, torch.bfloat16, "slow"),
    (1, 1, 64, 16, 32, torch.bfloat16, "fast"),
    # the tensor-core kernels at the f32 cases' shapes (K 20 takes the
    # plain staging loads: rows of 40 bytes), two chunks past the clip, and
    # three chunks of several batches and heads at K 32
    (1, 1, 16, 16, 16, torch.bfloat16, "slow"),
    (1, 1, 64, 64, 64, torch.bfloat16, "slow"),
    (1, 1, 128, 64, 64, torch.bfloat16, "fast"),
    (2, 1, 32, 20, 32, torch.bfloat16, "fast"),
    (2, 3, 96, 32, 32, torch.bfloat16, "slow"),
])
def test_emulated_backward_matches_plain_passes(B, H, S, K, L, dtype, decay, kernel):
    r, k, v, dout, logw, u, s0, ds1 = _inputs(B, H, S, K, dtype, decay, S + K + L)
    states, _ = chunk_states_ref(k, v, logw, s0, chunk=L)
    kp = rmod._kp(K)
    padded = torch.zeros((B, H, S // L, kp, kp))
    padded[..., :K, :K] = states
    if decay == "fast":
        cum = torch.cumsum(logw.reshape(B, H, S // L, L, K), 3)
        assert float((cum[..., -1:, :] - cum).min()) < -60.0
    n, tc = rmod.rwkv6_scan.bwd_launches, rmod.rwkv6_scan.bwd_tc_launches
    grads = rmod._launch_bwd(r, k, v, logw, u, padded, dout, ds1, L)
    assert rmod.rwkv6_scan.bwd_launches == n + rmod.BWD_KERNELS
    assert rmod.rwkv6_scan.bwd_tc_launches == tc + (
        rmod.BWD_TC_KERNELS if dtype == torch.bfloat16 else 0)
    refs = rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dout, ds1, chunk=L)
    for name, a, b, like in zip(NAMES, grads, refs, (r, k, v, logw, u, s0)):
        assert a.shape == like.shape and a.dtype == like.dtype, name
        rel = float((a.float() - b).abs().max() / b.abs().max())
        assert rel <= BWD_TOL[dtype], (name, rel)
        # dlogw, du and dstate0 are f32 in either instance: the tensor-core
        # products take their f32 operands in three bf16 parts, so these
        # hold the f32 tolerance (one bf16 part puts dlogw near 1e-3)
        if a.dtype == torch.float32:
            assert rel <= BWD_TOL[torch.float32], (name, rel)
