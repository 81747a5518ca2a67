"""rwkv6_scan's backward on the CPU.  The plain backward passes
(``ref.chunk_dstates_ref``, ``ref.chunk_grads_ref``: what the backward
kernels compute) against ``torch.autograd.grad`` of ``rwkv6_scan_ref``;
autograd of the port's ``chunked_wkv``, and the ``RwkvScan`` autograd
function on CPU tensors (the plain passes), against ``jax.grad`` of the
JAX package's ``chunked_wkv``; and three SGD steps of the rwkv6-7b SMOKE
config (f32, remat) from the JAX package's weights against the JAX
trainer.

Tolerances: every gradient within 1e-5 of its largest value (f32 sums in
another order; the plain passes keep exp(-60) where autograd's clip
gives zero, a term below 9e-27 of the products it scales).  The train
steps as ``tests/test_torch_train.py`` holds the dense ones: loss, CE and
grad_norm within 1e-5 relative, every param within 1e-5 of the largest
param value.  Inputs are drawn with numpy from a seed; each framework
gets its own copy."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.models.rwkv6 import chunked_wkv as jchunked_wkv
from repro.train import train_step as jts

from repro_torch.config import TrainConfig, get_smoke
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.rwkv6 import chunked_wkv
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.utils.tree import tree_flatten_with_names

rmod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")

torch.set_num_threads(1)

TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


@pytest.fixture(autouse=True)
def _plain_jax_scan():
    """The reference trains through its plain chunked_wkv on the CPU (its
    Pallas kernel has no VJP)."""
    set_kernels("auto")
    yield


def _draws(B, H, S, K, decay, seed):
    """numpy r, k, v, logw, u, state0, dout, d(s1) in the kernel layout
    (B, H, S, K); ``decay="fast"`` passes the clip at -60 in a chunk of 32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    lo, hi = (-6.0, -4.0) if decay == "slow" else (-1.0, 2.0)
    logw = -np.exp(rng.uniform(lo, hi, (B, H, S, K))).astype(np.float32)
    return (f(B, H, S, K, scale=0.5), f(B, H, S, K, scale=0.5), f(B, H, S, K, scale=0.5), logw,
            f(H, K, scale=0.5), f(B, H, K, K, scale=0.1), f(B, H, S, K), f(B, H, K, K))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("S,L,decay,state", [
    (64, 32, "slow", True),      # S = 2L, a state in and its gradient out
    (32, 32, "slow", True),      # S = L
    (64, 32, "fast", True),      # the clip at -60 reached
    (48, 16, "slow", False),     # three chunks from a zero state, no d(s1)
])
def test_plain_passes_equal_autograd(S, L, decay, state):
    B, H, K = 2, 3, 8
    draws = [torch.tensor(a) for a in _draws(B, H, S, K, decay, S + L)]
    r, k, v, logw, u, s0, dout, ds1 = draws
    if not state:
        s0, ds1 = torch.zeros_like(s0), torch.zeros_like(ds1)
    if decay == "fast":
        cum = torch.cumsum(logw.reshape(B, H, S // L, L, K), 3)
        assert float((cum[..., -1:, :] - cum).min()) < -60.0
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    out, s1 = rwkv6_scan_ref(*leaves, chunk=L)
    want = torch.autograd.grad((out * dout).sum() + (s1 * ds1).sum(), leaves)
    got = rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dout, ds1, chunk=L)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


@functools.cache
def _jax_grads(B, H, S, K, seed):
    """(the draws, jax.grad of the reference's chunked_wkv on them in the
    kernel layout), computed once for the cases that share them."""
    draws = _draws(B, H, S, K, "slow", seed)
    r, k, v, logw, u, s0, dout, ds1 = (jnp.asarray(a) for a in draws)
    flat = lambda x: jnp.moveaxis(x, 1, 2).reshape(B, S, H * K)

    def f(r, k, v, logw, u, s0):
        out, s1 = jchunked_wkv(flat(r), flat(k), flat(v), flat(logw), u.reshape(-1), s0, K)
        return jnp.sum(out * flat(dout)) + jnp.sum(s1 * ds1)

    grads = jax.jit(jax.grad(f, argnums=tuple(range(6))))(r, k, v, logw, u, s0)
    return draws, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("path", ["chunked_wkv", "RwkvScan"])
def test_port_grads_equal_jax_grad(path):
    """Two chunks of the reference's 64 at B 2, H 2, K 16, a state in."""
    B, H, S, K = 2, 2, 128, 16
    draws, want = _jax_grads(B, H, S, K, 7)
    r, k, v, logw, u, s0, dout, ds1 = (torch.tensor(a) for a in draws)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    if path == "chunked_wkv":
        flat = lambda x: x.movedim(1, 2).reshape(B, S, H * K)
        out, s1 = chunked_wkv(*(flat(t) for t in leaves[:4]), leaves[4].reshape(-1), leaves[5], K)
        loss = (out * flat(dout)).sum() + (s1 * ds1).sum()
    else:
        out, s1 = rmod.RwkvScan.apply(*leaves, 64)
        loss = (out * dout).sum() + (s1 * ds1).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(NAMES, got, want):
        assert tuple(a.shape) == b.shape, name
        assert _rel(a.numpy(), b) <= TOL, (name, _rel(a.numpy(), b))


def test_smoke_sgd_steps_match_jax():
    """Three SGD steps of the rwkv6-7b SMOKE config (2 layers, d 64, 4
    heads of 16, f32, remat) at B 2, S 128 (two chunks) from the
    reference's weights on the same batches."""
    jcfg, cfg = jget_smoke("rwkv6-7b"), get_smoke("rwkv6-7b")
    assert cfg.remat and cfg.dtype == "float32"
    tkw = dict(lr=0.2, warmup_steps=2, total_steps=50, optimizer="sgd")
    jtc, tc = JTrainConfig(**tkw), TrainConfig(**tkw)
    jmodel, model = jbuild_model(jcfg), build_model(cfg, "cpu")
    jstate = jts.init_train_state(jmodel, jtc, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    init, _ = optimizer.make_optimizer(tc)
    state = TrainState(params, init(params), torch.Generator().get_state(),
                       torch.zeros((), dtype=torch.int32))
    jstep, step = jax.jit(jts.make_train_step(jmodel, jtc)), make_train_step(model, tc)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 2, 129)).astype(np.int32)
    for t in toks:
        b = {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
        jstate, jm = jstep(jstate, {key: jnp.asarray(x) for key, x in b.items()})
        state, m = step(state, {key: torch.from_numpy(x.copy()) for key, x in b.items()})
        for key in ("loss", "ce", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=TOL), key
    assert int(state.step) == 3
    ref = dict(tree_flatten_with_names(params_to_jax(state.params)))
    for name, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        key = "/".join(str(p.key) for p in name)
        b = np.asarray(leaf)
        assert np.abs(ref[key] - b).max() <= TOL * np.abs(b).max(), key
