"""The PyTorch port's Mamba2 layer (``repro_torch.models.mamba2``), its
sinusoidal positions and cross attention against the JAX package's
functions, on inputs drawn with a numpy seed (each framework gets its own
copy of every buffer).

Tolerance: f32, max |diff| <= 1e-5 * max(1, max |ref|): XLA and torch take
the same f32 sums, exponentials and sines in another order or with
another last-bit rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke as jget_smoke
from repro.models import common as jcommon
from repro.models import mamba2 as jm2
from repro.models import transformer as jtf

from repro_torch.config import get_smoke
from repro_torch.models import common, mamba2 as m2
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"


def close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    bound = 1e-5 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, (err, bound)


def both(*arrays):
    """(JAX copies, torch copies) of numpy arrays."""
    return [jnp.array(a) for a in arrays], [torch.tensor(a) for a in arrays]


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_jax(with_carry):
    rng = np.random.default_rng(1)
    B, S, C, W = 2, 9, 24, 4
    arrays = [_normal(rng, B, S, C), _normal(rng, W, C, scale=0.1), _normal(rng, C, scale=0.1)]
    if with_carry:
        arrays.append(_normal(rng, B, W - 1, C))
    (jx, jw, jb, *jc), (x, w, b, *c) = both(*arrays)
    jout, jcarry = jax.jit(jm2._causal_conv)(jx, jw, jb, *jc)
    out, carry = m2._causal_conv(x, w, b, *c)
    close(out, jout)
    assert np.array_equal(carry.numpy(), np.asarray(jcarry))
    assert carry.shape == (B, W - 1, C)


def _ssd_inputs(seed, B, S, H, P, N, state):
    rng = np.random.default_rng(seed)
    x = _normal(rng, B, S, H, P)
    dt = np.log1p(np.exp(_normal(rng, B, S, H) - 1.0)).astype(np.float32)   # softplus > 0
    Bm, Cm = _normal(rng, B, S, N, scale=0.5), _normal(rng, B, S, N, scale=0.5)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    d_skip = (1.0 + _normal(rng, H, scale=0.1)).astype(np.float32)
    s0 = _normal(rng, B, H, P, N) if state else np.zeros((B, H, P, N), np.float32)
    return x, dt, Bm, Cm, a_log, d_skip, s0


@pytest.mark.parametrize("S,state", [(16, False), (128, False), (128, True)],
                         ids=["S16", "S128_two_chunks", "S128_from_state"])
def test_chunked_ssd_matches_jax(S, state):
    j, t = both(*_ssd_inputs(S + state, 2, S, 3, 8, 6, state))
    jy, jstate = jax.jit(jm2.chunked_ssd)(*j)
    y, s1 = m2.chunked_ssd(*t)
    assert y.dtype == s1.dtype == torch.float32
    close(y, jy)
    close(s1, jstate)


def test_chunked_ssd_needs_whole_chunks():
    t = [torch.tensor(a) for a in _ssd_inputs(0, 1, 96, 2, 4, 4, False)]
    with pytest.raises(ValueError, match="chunk"):
        m2.chunked_ssd(*t)


@pytest.fixture(scope="module")
def block():
    """The SMOKE config's Mamba2 parameters (f32) from the JAX init, and a
    non-zero starting state."""
    jcfg = jget_smoke(ARCH)
    jp = jm2.init_mamba_params(jcommon.KeyGen(jax.random.key(4)), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    np_p["dt_bias"] = _normal(rng, *np_p["dt_bias"].shape, scale=0.5)
    inner, nheads = jm2.dims(jcfg)
    conv_ch = inner + 2 * jcfg.ssm_state
    s0 = (_normal(rng, 2, nheads, jcfg.ssm_head_dim, jcfg.ssm_state, scale=0.3),
          _normal(rng, 2, jcfg.ssm_conv_width - 1, conv_ch))
    return jcfg, get_smoke(ARCH), np_p, s0


def _params(np_p):
    return ({k: jnp.array(v) for k, v in np_p.items()}, {k: torch.tensor(v) for k, v in np_p.items()})


def test_init_mamba_params_match_jax(block):
    jcfg, cfg, np_p, _ = block
    p = m2.init_mamba_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert list(p) == list(np_p)
    for k, v in p.items():
        assert tuple(v.shape) == np_p[k].shape and v.dtype == torch.float32, k
    for k in ("a_log", "d_skip", "norm"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jm2.init_mamba_params(
            jcommon.KeyGen(jax.random.key(0)), jcfg, jnp.float32)[k]), rtol=1e-6)


@pytest.mark.parametrize("S,state", [(16, False), (128, True)], ids=["S16_zero", "S128_from_state"])
def test_mamba_block_matches_jax(block, S, state):
    jcfg, cfg, np_p, s0 = block
    jp, p = _params(np_p)
    rng = np.random.default_rng(S)
    x = _normal(rng, 2, S, cfg.d_model)
    st = s0 if state else tuple(np.zeros_like(a) for a in s0)
    (jx, js, jc), (tx, ts, tc) = both(x, *st)
    jout, jstate = jax.jit(jm2.mamba_block, static_argnums=1)(jp, jcfg, jx, jm2.MambaState(js, jc))
    out, new = m2.mamba_block(p, cfg, tx, m2.MambaState(ts, tc))
    close(out, jout)
    close(new.ssd, jstate.ssd)
    close(new.conv, jstate.conv)


def test_mamba_block_decode_reaches_the_reference_state(block):
    """The port, one token at a time from a non-zero state, gives the JAX
    block's full-sequence outputs row by row and ends in its state."""
    jcfg, cfg, np_p, s0 = block
    jp, p = _params(np_p)
    S = 12
    x = _normal(np.random.default_rng(7), 2, S, cfg.d_model)
    (jx, js, jc), (tx, ts, tc) = both(x, *s0)
    jout, jstate = jax.jit(jm2.mamba_block, static_argnums=1)(jp, jcfg, jx, jm2.MambaState(js, jc))
    state = m2.MambaState(ts, tc)
    rows = []
    for t in range(S):
        out, state = m2.mamba_block(p, cfg, tx[:, t : t + 1], state)
        rows.append(out)
    close(torch.cat(rows, dim=1), jout)
    close(state.ssd, jstate.ssd)
    close(state.conv, jstate.conv)


@pytest.mark.parametrize("seq,dim", [(24, 64), (1500, 384)])
def test_sinusoidal_positions_match_jax(seq, dim):
    ref = np.asarray(jcommon.sinusoidal_positions(seq, dim, jnp.float32))
    out = common.sinusoidal_positions(seq, dim, torch.float32)
    assert np.array_equal(out.numpy(), ref)
    assert common.sinusoidal_positions(seq, dim, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("pos", [0, 1, 7, 40, 447])
def test_sinusoidal_at_matches_jax(pos):
    """The decode row in f32 (the prefill table is f64 cast to f32: the
    two differ by about pos * 2**-24, in both packages)."""
    ref = jax.jit(jcommon.sinusoidal_at, static_argnums=(1, 2))(jnp.int32(pos), 64, jnp.float32)
    out = common.sinusoidal_at(pos, 64)
    assert out.dtype == torch.float32 and out.shape == (64,)
    close(out, ref)


@pytest.mark.parametrize("arch,S,T", [("whisper-tiny", 5, 24), ("whisper-tiny", 1, 40),
                                      ("zamba2-1.2b", 3, 7)])
def test_cross_attention_matches_jax(arch, S, T):
    """With biases (whisper) and without; one query (decode) and several."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    rng = np.random.default_rng(S * T)
    jp = jtf.init_attn_params(jcommon.KeyGen(jax.random.key(S)), jcfg, jnp.float32, cross=True)
    np_p = {k: np.asarray(v) + (_normal(rng, *v.shape, scale=0.1) if k.startswith("b") else 0)
            for k, v in jp.items()}
    assert ("bq" in np_p) == (arch == "whisper-tiny")
    x = _normal(rng, 2, S, cfg.d_model)
    ek, ev = (_normal(rng, 2, T, cfg.num_kv_heads, cfg.head_dim) for _ in range(2))
    (jx, jk, jv), (tx, tk, tv) = both(x, ek, ev)
    jpp, pp = _params(np_p)
    ref = jax.jit(jtf.cross_attention, static_argnums=1)(jpp, jcfg, jx, jk, jv)
    out = tf.cross_attention(pp, cfg, tx, tk, tv)
    close(out, ref)
    assert tf.init_attn_params(torch.Generator(), cfg, torch.float32, cross=True).keys() == jp.keys()
