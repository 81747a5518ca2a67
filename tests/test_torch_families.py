"""The PyTorch port's hybrid, encdec and vlm families (zamba2-1.2b,
whisper-tiny, internvl2-2b) against the JAX package at their SMOKE
configs (f32), with the JAX weights carried across by ``params_from_jax``:
the configs, the converter's round trip, forward logits, decode chains,
the quantized leaves and the quantized decode, greedy ``ServeEngine``
tokens and the serve CLI.

The JAX side runs on its default CPU path: ``blocked_attention`` in place
of the flash kernel and the plain fixmatmul (the port's CPU wrappers take
the same plain versions).  At whisper's SMOKE context (24 frames) and at
a ragged one (40) the JAX flash op would pad no key; at the full 1500
frames it pads the keys to 1536 and attends to the pad, which the
blocked path (and the port) mask.

Tolerances: logits at atol = rtol = 1e-4 (forward) and 1e-5 (a decode
step), as XLA and torch take the same f32 sums in another order; the
quantized codes and scales are exact; greedy tokens equal.  Quantized
decode: the activations are quantized per row at run time, so a last-bit
difference in a projection's f32 input can move one activation's int8
code by one step where x / scale sits on a rounding edge; that moves the
logits of that step by up to QUANT_TOL (2.7e-3 on internvl2's chain here),
and every other step agrees at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.models.quantized import quantize_params as jquantize_params
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.config import ServeConfig, get_arch, get_smoke
from repro_torch.kernels.fixmatmul import ops as fix_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.quantized import quantize_params
from repro_torch.serve import ServeEngine
from repro_torch.utils.tree import tree_flatten_with_names

torch.set_num_threads(1)

ARCHS = ["zamba2-1.2b", "whisper-tiny", "internvl2-2b"]
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_TOL = 5e-3
# (leaves quantize_params makes, fixmatmul calls a decode step) at SMOKE
QUANT = {"zamba2-1.2b": (8, 7 * 2 + 1), "whisper-tiny": (2 * 10 + 2 * 6 + 1, 2 * 8 + 1),
         "internvl2-2b": (2 * 7 + 1, 2 * 7 + 1)}
PROMPTS = [[3, 14, 15, 9, 26, 5, 35, 8], [1, 2, 3, 4], [400, 12, 7, 511, 0, 44]]
MAX_LEN = 24            # the engine's cache length, and the decode chains'



@pytest.fixture(autouse=True)
def _plain_reference():
    set_kernels("auto")


def _batch(cfg, B, S, seed, frames=None):
    """Tokens and, for the encdec and vlm families, the stub frontend, as
    numpy arrays drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal((B, frames or cfg.encoder_ctx, cfg.d_model))
    elif cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal((B, cfg.vision_tokens, cfg.vision_dim))
    return {k: v.astype(np.float32) if k == "frontend" else v for k, v in batch.items()}


def _both(batch):
    return ({k: jnp.array(v) for k, v in batch.items()},
            {k: torch.tensor(v, dtype=torch.int64 if k == "tokens" else torch.float32)
             for k, v in batch.items()})


def _pair(arch, seed=0, **replace):
    jcfg, cfg = (g(arch).replace(**replace) for g in (jget_smoke, get_smoke))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    m = build_model(cfg, "cpu")
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return (request.param, *_pair(request.param))


@pytest.fixture(scope="module")
def qpair(pair):
    """``pair`` with both packages' int8 weights."""
    arch, jm, jp, m, p = pair
    return arch, jm, jquantize_params(jp), m, quantize_params(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(jget_smoke(arch))
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(jget_arch(arch))


def test_params_round_trip(pair):
    """zamba2's ``layers`` stay a list on both sides; whisper's
    ``enc_layers`` are cut into ``num_encoder_layers`` and stacked back."""
    arch, jm, jp, m, p = pair
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    cfg = m.cfg
    assert len(p["layers"]) == cfg.num_layers
    if cfg.family == "encdec":
        assert len(p["enc_layers"]) == cfg.num_encoder_layers
        assert p["enc_layers"][1]["attn"]["wq"].shape == (cfg.d_model, cfg.q_dim)
    if cfg.family == "hybrid":
        assert isinstance(jp["layers"], list) and isinstance(back["layers"], list)


def test_init_has_the_reference_leaves(pair):
    """``init`` draws the reference's leaves, shapes and dtypes."""
    arch, jm, jp, m, p = pair
    mine = params_to_jax(m.init(3))
    assert jax.tree.structure(mine) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(mine)):
        assert np.asarray(a).shape == b.shape and np.asarray(a).dtype == b.dtype


def test_forward_matches_jax(pair):
    """S 128: two of zamba2's 64-token SSD chunks."""
    S = 128
    arch, jm, jp, m, p = pair
    jb, tb = _both(_batch(m.cfg, 2, S, S))
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    logits, aux = m.forward(p, tb)
    assert logits.shape == (2, S, m.cfg.padded_vocab) and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **FWD_TOL)


def test_whisper_ragged_encoder_ctx():
    """A ragged encoder context (40 frames), against the JAX model's
    default CPU path (``blocked_attention``, which masks the true key
    length)."""
    jm, jp, m, p = _pair("whisper-tiny", seed=5, encoder_ctx=40)
    jb, tb = _both(_batch(m.cfg, 2, 6, 40, frames=40))
    jl, _ = jax.jit(jm.forward)(jp, jb)
    logits, _ = m.forward(p, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **FWD_TOL)
    assert m.init_cache(2, 8).cross_k.shape == (2, 2, 40, 4, 16)


def test_vlm_forward_without_frontend():
    """The vlm family reads text alone when the batch has no frontend."""
    jm, jp, m, p = _pair("internvl2-2b", seed=6)
    toks = _batch(m.cfg, 2, 8, 9)["tokens"]
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.array(toks)})
    logits, _ = m.forward(p, {"tokens": torch.tensor(toks, dtype=torch.int64)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **FWD_TOL)


def _decode_both(jm, jp, m, p, toks, cache_len):
    jc, c = jm.init_cache(toks.shape[0], cache_len), m.init_cache(toks.shape[0], cache_len)
    jd = jax.jit(jm.decode_step)
    for t in range(toks.shape[1]):
        jl, jc = jd(jp, jc, jnp.array(toks[:, t : t + 1]))
        logits, c = m.decode_step(p, c, torch.tensor(toks[:, t : t + 1], dtype=torch.int64))
        yield t, jl, jc, logits, c


def _check_cache(arch, jc, c, t):
    if arch == "zamba2-1.2b":
        for js, s in zip(jc.mamba, c.mamba):
            np.testing.assert_allclose(s.ssd.numpy(), np.asarray(js.ssd), **TOL)
            np.testing.assert_allclose(s.conv.numpy(), np.asarray(js.conv), **TOL)
        for ja, a in zip(jc.attn, c.attn):
            assert a.pos == t + 1 == int(np.asarray(ja.pos))
            np.testing.assert_allclose(a.k.numpy(), np.asarray(ja.k), **TOL)
    else:
        kv = jc.self_kv if arch == "whisper-tiny" else jc
        mine = c.self_kv if arch == "whisper-tiny" else c
        assert mine.pos == t + 1 and np.all(np.asarray(kv.pos) == t + 1)
        np.testing.assert_allclose(mine.k.numpy(), np.asarray(kv.k), **TOL)
        np.testing.assert_allclose(mine.v.numpy(), np.asarray(kv.v), **TOL)
    if arch == "whisper-tiny":
        assert not c.cross_k.any() and not c.cross_v.any()


def test_decode_steps_match_jax(pair):
    """An 8-token chain; the logits and every cache after each step."""
    arch, jm, jp, m, p = pair
    toks = _batch(m.cfg, 3, 8, 7)["tokens"]
    for t, jl, jc, logits, c in _decode_both(jm, jp, m, p, toks, cache_len=MAX_LEN):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _check_cache(arch, jc, c, t)


def test_quantized_leaves_match_jax(qpair):
    """quantize_params quantizes exactly the reference's leaves: the shared
    block's attention and MLP, whisper's attention, cross attention and
    MLP (the encoder's too), the decoder's, and lm_head; never the Mamba
    projections, ``proj_in`` or ``vision_proj``.  Codes and scales exact."""
    arch, jm, jq, m, q = qpair
    back = params_to_jax(q)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    names = [n for n, _ in tree_flatten_with_names(q) if n.endswith("/q")]
    assert len(names) == QUANT[arch][0]
    assert not any(w in n for n in names for w in ("mamba", "proj_in", "vision_proj"))


def test_quantized_decode_matches_jax(qpair, monkeypatch):
    """Decode with int8 weights on both sides; the int8 MLP drops its
    biases in both packages (whisper's ``use_bias``).  Counts the
    fixmatmul calls a step: each quantized leaf a decode step reaches
    (whisper's encoder and cross wk/wv are quantized but idle).  At most
    one step of the chain may take an activation code one step off (see
    QUANT_TOL); the others hold at 1e-5."""
    arch, jm, jq, m, q = qpair
    toks = _batch(m.cfg, 3, 6, 11)["tokens"]
    calls = []
    plain = fix_ops.fixmatmul
    monkeypatch.setattr(fix_ops, "fixmatmul", lambda *a: (calls.append(1), plain(*a))[1])
    off = 0
    for t, jl, jc, logits, c in _decode_both(jm, jq, m, q, toks, cache_len=MAX_LEN):
        d = np.abs(logits.numpy() - np.asarray(jl))
        assert d.max() <= QUANT_TOL, (t, d.max())
        off += not np.allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert off <= 1
    assert len(calls) == QUANT[arch][1] * toks.shape[1]


@pytest.mark.parametrize("weights", ["plain", "quantized"])
def test_engine_tokens_equal_jax(pair, qpair, weights):
    """Unequal prompt lengths (pad zeros replayed, as in the reference);
    10 greedy tokens.  (The decode chains above use the engine's batch and
    cache length, so the JAX engine reuses their compiled step.)"""
    arch, jm, jp, m, p = pair if weights == "plain" else qpair
    ref = JServeEngine(jm, jp, JServeConfig(), max_len=MAX_LEN).generate(PROMPTS, 10)
    out = ServeEngine(m, p, ServeConfig(), max_len=MAX_LEN).generate(PROMPTS, 10)
    assert out == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "4",
                           "--new-tokens", "3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[serve] 6 new tokens" in out and "on cpu" in out
