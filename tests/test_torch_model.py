"""The PyTorch port's dense decoder LM against the JAX package, on the
h2o-danube-1.8b SMOKE config (2 layers, d 64, GQA 4/2, head_dim 16, a
sliding window of 8, f32), with the JAX package's weights carried across
by ``params_from_jax``.

Tolerances: float logits and caches at atol = rtol = 1e-5, since XLA and
torch take the same f32 sums, roots, sines and cosines in another order
or with another last-bit rounding.  Quantized codes and scales are exact.
Quantized logits too (see ``test_quantized_decode_matches_jax``).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.models.quantized import quantization_error as jquantization_error
from repro.models.quantized import quantize_params as jquantize_params

from repro_torch.config import get_arch, get_smoke
from repro_torch.models import build_model
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.quantized import quantization_error, quantize_params
from repro_torch.utils.tree import tree_flatten_with_names

torch.set_num_threads(1)

ARCH = "h2o-danube-1.8b"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    set_kernels("interpret")
    yield
    set_kernels("auto")


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    m = build_model(cfg, "cpu")
    return jm, jp, m, params_from_jax(np_params, cfg, "cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_config_equals_reference():
    assert dataclasses.asdict(get_smoke(ARCH)) == dataclasses.asdict(jget_smoke(ARCH))
    full = get_arch(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jget_arch(ARCH))
    assert (full.kv_dim, full.q_dim, full.padded_vocab) == (640, 2560, 32000)


def test_other_archs_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        get_arch("starcoder2-7b")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    with pytest.raises(NotImplementedError):
        build_model(get_smoke(ARCH).replace(family="moe"), "cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke(ARCH))


def test_params_round_trip(pair):
    jm, jp, m, p = pair
    assert len(p["layers"]) == 2 and p["layers"][0]["attn"]["wq"].shape == (64, 64)
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("S", [5, 24])
def test_forward_matches_jax(pair, S):
    jm, jp, m, p = pair
    toks = _tokens(S, (2, S))
    jl, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.array(toks)})
    logits, aux = m.forward(p, {"tokens": torch.tensor(toks, dtype=torch.int64)})
    assert logits.shape == (2, S, 512) and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def _decode_both(jm, jp, m, p, toks, cache_len):
    jc, c = jm.init_cache(toks.shape[0], cache_len), m.init_cache(toks.shape[0], cache_len)
    jd = jax.jit(jm.decode_step)
    for t in range(toks.shape[1]):
        jl, jc = jd(jp, jc, jnp.array(toks[:, t : t + 1]))
        logits, c = m.decode_step(p, c, torch.tensor(toks[:, t : t + 1], dtype=torch.int64))
        yield t, jl, jc, logits, c


def test_decode_steps_match_jax(pair):
    """12 tokens through a window-8 ring buffer: the cache wraps."""
    jm, jp, m, p = pair
    toks = _tokens(7, (2, 12))
    for t, jl, jc, logits, c in _decode_both(jm, jp, m, p, toks, cache_len=32):
        assert c.k.shape == (2, 2, 8, 2, 16) and c.pos == t + 1
        assert np.all(np.asarray(jc.pos) == t + 1)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), **TOL)


def test_decode_without_window_matches_jax():
    """A full (non-ring) cache: slot = pos, mask idx <= pos."""
    jcfg, cfg = (g(ARCH).replace(sliding_window=None, num_layers=1) for g in (jget_smoke, get_smoke))
    jm, m = jbuild_model(jcfg), build_model(cfg, "cpu")
    jp = jm.init(jax.random.key(3))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(3, (1, 6))
    for _, jl, jc, logits, c in _decode_both(jm, jp, m, p, toks, cache_len=10):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert c.k.shape[2] == 10


def test_quantize_params_exact(pair):
    jm, jp, m, p = pair
    jq = jquantize_params(jp)
    q = quantize_params(p)
    back = params_to_jax(q)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    names = [n for n, _ in tree_flatten_with_names(q)]
    assert "layers/1/mlp/w2/q" in names and "lm_head/s" in names and "embed/tokens" in names
    errs, jerrs = quantization_error(p, q), jquantization_error(jp, jq)
    assert {re.sub(r"^layers/\d+/", "layers/", n) for n in errs} == set(jerrs)
    assert len(errs) == 2 * 7 + 1 and errs["lm_head"] == pytest.approx(jerrs["lm_head"], rel=1e-6)
    assert max(errs.values()) < 0.02


def test_quantized_decode_matches_jax(pair):
    """Decode with int8 weights on both sides.  The activations are
    quantized per row at run time, so a last-bit difference in the f32
    input of a projection could move one activation code by one step; on
    these inputs none does, and the logits agree as the float ones do."""
    jm, jp, m, p = pair
    jq, q = jquantize_params(jp), quantize_params(p)
    toks = _tokens(11, (2, 10))
    for _, jl, jc, logits, c in _decode_both(jm, jq, m, q, toks, cache_len=16):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_init_draws_from_the_reference_distributions():
    cfg = get_smoke(ARCH).replace(d_model=256, d_ff=512, num_heads=4, head_dim=64)
    p = build_model(cfg, "cpu").init(5)
    again = build_model(cfg, "cpu").init(torch.Generator().manual_seed(5))
    assert torch.equal(p["layers"][1]["mlp"]["w2"], again["layers"][1]["mlp"]["w2"])
    emb = p["embed"]["tokens"]
    assert emb.shape == (512, 256) and abs(float(emb.std()) - 0.02) < 0.002
    w1 = p["layers"][0]["mlp"]["w1"]                      # fan_in 256
    assert abs(float(w1.std()) - 256 ** -0.5) < 0.003 and abs(float(w1.mean())) < 0.003
    w2 = p["layers"][0]["mlp"]["w2"]                      # fan_in 512
    assert abs(float(w2.std()) - 512 ** -0.5) < 0.002
    assert torch.equal(p["final_w"], torch.ones(256))


def test_int8_kv_cache_not_ported():
    cfg = get_smoke(ARCH).replace(kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        build_model(cfg, "cpu").init_cache(1, 8)
    assert KVCache.init(1, 4, 2, 8, torch.float32, "cpu").pos == 0
