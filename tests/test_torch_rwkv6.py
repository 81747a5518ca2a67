"""The PyTorch port's rwkv6 family against the JAX package: the plain
version of the rwkv6_scan kernel (``chunked_wkv`` behind the CPU wrapper)
the closed form of its CUDA decode route (``decode_ref``) and the two-pass
split of its CUDA prefill route (each chunk's start state, then every
chunk's output from it) against the Pallas kernel in interpret mode, the
kernels' ``route``, and the rwkv6-7b SMOKE model
(2 layers, d 64, 4 heads of 16, f32) with the JAX weights carried across
by ``params_from_jax``: forward, decode steps, the quantized ``lm_head``,
the serve engine's greedy tokens and the CLI.

Tolerances: the scan at atol 1e-4, as the JAX package's own kernel tests
hold it (f32 sums of up to 64-term decay-weighted products in another
order).  Logits at atol = rtol = 1e-5; the carried states at atol 1e-4,
rtol 1e-5 (they reach ~10 and carry their rounding from step to step).
Quantized codes and scales, and greedy tokens, are exact.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.kernels.rwkv6_scan.ops import wkv as jwkv
from repro.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan as jrwkv6_scan
from repro.models import build_model as jbuild_model
from repro.models.quantized import quantize_params as jquantize_params
from repro.models.rwkv6 import chunked_wkv as jchunked_wkv
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.config import ServeConfig, get_arch, get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.quantized import quantize_params
from repro_torch.models.rwkv6 import RWKVState, chunked_wkv
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_ref, wkv
from repro_torch.kernels.rwkv6_scan.ref import (chunk_states_ref, decode_ref,
                                                rwkv6_scan_two_pass_ref)
from repro_torch.serve import ServeEngine
from repro_torch.utils.tree import tree_flatten_with_names

rmod = importlib.import_module("repro_torch.kernels.rwkv6_scan.rwkv6_scan")

torch.set_num_threads(1)

ARCH = "rwkv6-7b"
TOL = dict(atol=1e-5, rtol=1e-5)
STATE_TOL = dict(atol=1e-4, rtol=1e-5)
SCAN_TOL = dict(atol=1e-4, rtol=0)
PROMPTS = [[3, 14, 15, 9, 26, 5, 35, 8, 97, 9, 32], [1, 2, 3, 4], [400, 12, 7, 511, 0, 44, 2]]


@pytest.fixture(autouse=True)
def _interpret_kernels():
    set_kernels("interpret")
    yield
    set_kernels("auto")


def _scan_inputs(seed, B, H, S, K, s0_scale=0.1):
    """numpy inputs of the JAX kernel tests' distributions."""
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=0.5: (rng.normal(size=s) * scale).astype(np.float32)
    r, k, v = t(B, H, S, K), t(B, H, S, K), t(B, H, S, K)
    logw = -np.exp(rng.uniform(-6, -4, (B, H, S, K))).astype(np.float32)
    return r, k, v, logw, t(H, K), t(B, H, K, K, scale=s0_scale)


def _both(arrays):
    """Each framework gets its own copy of each array."""
    return [jnp.array(a) for a in arrays], [torch.tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

SCAN_SHAPES = [
    (1, 2, 64, 16, 32), (2, 3, 128, 16, 64), (1, 1, 256, 32, 64),   # tests/test_kernels.py
    (2, 2, 8, 16, 1),                                               # L = 1
    (1, 2, 40, 16, 64),                                             # S < 64: L = S
    (2, 2, 1, 64, 64),                                              # decode: S = 1, K 64
    (1, 2, 96, 16, 16),                                             # six chunks of 16
]


@pytest.mark.parametrize("B,H,S,K,chunk", SCAN_SHAPES)
def test_scan_matches_pallas_kernel(B, H, S, K, chunk):
    ins = _scan_inputs(B * 100 + S + chunk, B, H, S, K)
    (jr, jk, jv, jw, ju, js0), args = _both(ins)
    jout, js1 = jrwkv6_scan(jr, jk, jv, jw, ju, js0, chunk=chunk, interpret=True)
    out, s1 = rwkv6_scan(*args, chunk=chunk)
    assert out.shape == (B, H, S, K) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **SCAN_TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **SCAN_TOL)


@pytest.mark.parametrize("B,H,S,K,chunk", SCAN_SHAPES)
def test_two_pass_decomposition_matches_chunked_wkv_and_pallas(B, H, S, K, chunk):
    """The split the CUDA prefill route makes, in plain PyTorch: each
    chunk's start state by the state pass's recurrence, then every chunk's
    output from its start state, gives chunked_wkv's result and the Pallas
    kernel's (interpret mode)."""
    ins = _scan_inputs(B * 100 + S + chunk, B, H, S, K)
    (jr, jk, jv, jw, ju, js0), args = _both(ins)
    jout, js1 = jrwkv6_scan(jr, jk, jv, jw, ju, js0, chunk=chunk, interpret=True)
    out, s1 = rwkv6_scan_two_pass_ref(*args, chunk=chunk)
    ref, ref_s1 = rwkv6_scan_ref(*args, chunk=chunk)
    assert out.shape == (B, H, S, K) and out.dtype == torch.float32
    for got, want in ((out, np.asarray(jout)), (s1, np.asarray(js1)), (out, ref.numpy()),
                      (s1, ref_s1.numpy())):
        np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


def test_chunk_states_are_the_states_after_each_prefix():
    """Chunk c's start state is s0 for c = 0, then the state after the
    first c chunks (the plain version over that prefix)."""
    r, k, v, logw, u, s0 = (torch.tensor(a) for a in _scan_inputs(11, 2, 3, 96, 16))
    states, s1 = chunk_states_ref(k, v, logw, s0, chunk=16)
    assert states.shape == (2, 3, 6, 16, 16) and torch.equal(states[:, :, 0], s0)
    for c in range(1, 6):
        _, s_c = rwkv6_scan_ref(r[:, :, :16 * c], k[:, :, :16 * c], v[:, :, :16 * c],
                                logw[:, :, :16 * c], u, s0, chunk=16)
        np.testing.assert_allclose(states[:, :, c].numpy(), s_c.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(s1.numpy(), rwkv6_scan_ref(r, k, v, logw, u, s0, chunk=16)[1].numpy(),
                               **SCAN_TOL)


@pytest.mark.parametrize("K", [16, 64])
def test_decode_ref_matches_chunked_wkv_and_pallas(K):
    """The decode route's closed form at S = 1 (out = r S0 + (r u k) v,
    S1 = S0 exp(logw) + k^T v) gives chunked_wkv's result and the Pallas
    kernel's (interpret mode)."""
    ins = _scan_inputs(300 + K, 2, 3, 1, K)
    (jr, jk, jv, jw, ju, js0), args = _both(ins)
    jout, js1 = jrwkv6_scan(jr, jk, jv, jw, ju, js0, chunk=64, interpret=True)
    out, s1 = decode_ref(*args)
    ref, ref_s1 = rwkv6_scan_ref(*args)
    assert out.shape == (2, 3, 1, K) and out.dtype == torch.float32
    for got, want in ((out, np.asarray(jout)), (s1, np.asarray(js1)), (out, ref.numpy()),
                      (s1, ref_s1.numpy())):
        np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("S,chunk,route", [
    (1, 64, "decode"), (40, 64, "one_block"), (64, 64, "one_block"), (1, 1, "decode"),
    (16, 16, "one_block"), (128, 64, "chunked"), (8192, 64, "chunked"), (32, 16, "chunked"),
    (2, 1, "chunked"), (192, 64, "chunked"), (1, 16, "decode"), (2, 64, "one_block"),
    (63, 64, "one_block"),
])
def test_route_takes_the_two_passes_from_two_chunks(S, chunk, route):
    """One step (the decode step) goes to the decode kernel, one chunk of
    L = min(chunk, S) > 1 to the one-block kernel, two or more (the
    prefill) to the two passes."""
    assert rmod.route(S, chunk) == route


def test_scan_rejects_an_unknown_kernel():
    args = [torch.tensor(a) for a in _scan_inputs(12, 1, 2, 64, 16)]
    with pytest.raises(ValueError, match="kernel must be one of"):
        rwkv6_scan(*args, kernel="two_pass")
    out, _ = rwkv6_scan(*args, kernel="chunked")      # the CPU takes the plain version either way
    assert torch.equal(out, rwkv6_scan(*args)[0])


@pytest.mark.parametrize("S", [1, 64])
def test_scan_accepts_the_decode_kernel_and_the_cpu_ignores_it(S):
    """``kernel="decode"`` passes the validator; on the CPU the plain
    version runs whatever the kernel and the number of steps."""
    args = [torch.tensor(a) for a in _scan_inputs(13, 1, 2, S, 16)]
    launches = (rwkv6_scan.launches, rwkv6_scan.decode_launches)
    out, s1 = rwkv6_scan(*args, kernel="decode")
    ref, ref_s1 = rwkv6_scan_ref(*args)
    assert torch.equal(out, ref) and torch.equal(s1, ref_s1)
    assert (rwkv6_scan.launches, rwkv6_scan.decode_launches) == launches


def test_scan_state_chains():
    """Two halves with the state carried == the whole run."""
    r, k, v, logw, u, _ = (torch.tensor(a) for a in _scan_inputs(5, 1, 2, 128, 16))
    s0 = torch.zeros((1, 2, 16, 16))
    full, s_full = rwkv6_scan(r, k, v, logw, u, s0, chunk=32)
    h1, s_mid = rwkv6_scan(r[:, :, :64], k[:, :, :64], v[:, :, :64], logw[:, :, :64], u, s0,
                           chunk=32)
    h2, s_end = rwkv6_scan(r[:, :, 64:], k[:, :, 64:], v[:, :, 64:], logw[:, :, 64:], u, s_mid,
                           chunk=32)
    np.testing.assert_allclose(torch.cat([h1, h2], 2).numpy(), full.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(s_end.numpy(), s_full.numpy(), **SCAN_TOL)


def test_scan_state_out_may_alias_state0():
    ins = [torch.tensor(a) for a in _scan_inputs(6, 2, 2, 64, 16)]
    out, s1 = rwkv6_scan(*ins)
    s0 = ins[5].clone()
    out2, s2 = rwkv6_scan(*ins[:5], s0, state_out=s0)
    assert s2 is s0 and torch.equal(out2, out) and torch.equal(s0, s1)


def test_scan_rejects_ragged_chunks_and_bad_operands():
    r, k, v, logw, u, s0 = (torch.tensor(a) for a in _scan_inputs(7, 1, 2, 96, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6_scan(r, k, v, logw, u, s0, chunk=64)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan(r, k, v, logw.double(), u, s0, chunk=32)
    with pytest.raises(ValueError, match="do not agree"):
        rwkv6_scan(r, k, v, logw, u[:1], s0, chunk=32)


def test_scan_bf16_out_is_rounded_once():
    """bf16 r/k/v: the sums run in f32 and ``out`` is rounded to bf16 at
    the end, as the Pallas kernel does."""
    r, k, v, logw, u, s0 = (torch.tensor(a) for a in _scan_inputs(8, 1, 2, 64, 16))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    out, s1 = rwkv6_scan(rb, kb, vb, logw, u, s0)
    ref, ref_s1 = rwkv6_scan_ref(rb, kb, vb, logw, u, s0)
    assert out.dtype == torch.bfloat16 and ref.dtype == torch.float32
    assert torch.equal(out, ref.to(torch.bfloat16)) and torch.equal(s1, ref_s1)


def test_wkv_op_and_chunked_wkv_match_jax():
    """The (B, S, D) op and the plain recurrence itself."""
    r, k, v, logw, u, s0 = _scan_inputs(9, 2, 4, 128, 16)
    flat = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, 2).reshape(2, 128, 64))
    ins = [flat(r), flat(k), flat(v), flat(logw), u.reshape(64), s0]
    (jr, jk, jv, jw, ju, js0), (pr, pk, pv, pw, pu, ps0) = _both(ins)
    jout, js1 = jwkv(jr, jk, jv, jw, ju, js0, 16)
    out, s1 = wkv(pr, pk, pv, pw, pu, ps0, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **SCAN_TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **SCAN_TOL)
    jout, js1 = jchunked_wkv(jr, jk, jv, jw, ju, js0, 16)
    out, s1 = chunked_wkv(pr, pk, pv, pw, pu, ps0, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **SCAN_TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), **SCAN_TOL)


# ---------------------------------------------------------------------------
# the SMOKE model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m = build_model(cfg, "cpu")
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_config_equals_reference():
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(jget_arch(ARCH))
    assert dataclasses.asdict(get_smoke(ARCH)) == dataclasses.asdict(jget_smoke(ARCH))
    full = get_arch(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.ssm_head_dim, full.padded_vocab) == (
        "rwkv6", 32, 4096, 64, 65536)


def test_params_round_trip(pair):
    jm, jp, m, p = pair
    assert len(p["layers"]) == 2 and p["layers"][0]["time"]["wr"].shape == (64, 64)
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)


def test_bf16_params_keep_their_f32_leaves():
    """Under a bf16 model ``w0``, ``u`` and ``ln_x`` stay f32, on both
    sides and across the conversion."""
    jcfg, cfg = (g(ARCH).replace(dtype="bfloat16", num_layers=1) for g in (jget_smoke, get_smoke))
    jp = jbuild_model(jcfg).init(jax.random.key(1))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    own = build_model(cfg, "cpu").init(1)
    for params in (p, own):
        tm = params["layers"][0]["time"]
        assert {n for n, t in tm.items() if t.dtype == torch.float32} == {"w0", "u", "ln_x"}
        assert tm["wr"].dtype == params["embed"]["tokens"].dtype == torch.bfloat16
    assert sorted((n, tuple(t.shape), t.dtype) for n, t in tree_flatten_with_names(own)) == sorted(
        (n, tuple(t.shape), t.dtype) for n, t in tree_flatten_with_names(p))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params_to_jax(p))):
        assert np.array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("S", [5, 24, 128])
def test_forward_matches_jax(pair, S):
    """S 5 and 24: one chunk of S; S 128: two chunks of 64."""
    jm, jp, m, p = pair
    toks = _tokens(S, (2, S))
    jl, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.array(toks)})
    logits, aux = m.forward(p, {"tokens": torch.tensor(toks, dtype=torch.int64)})
    assert logits.shape == (2, S, 512) and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_forward_hook_takes_the_plain_recurrence(pair):
    _, _, m, p = pair
    toks = torch.tensor(_tokens(3, (1, 64)), dtype=torch.int64)
    a, _ = m.forward(p, {"tokens": toks})
    b, _ = m.forward(p, {"tokens": toks}, wkv=chunked_wkv)
    assert torch.equal(a, b)


def _decode_both(jm, jp, m, p, toks):
    jc, c = jm.init_cache(toks.shape[0], 16), m.init_cache(toks.shape[0], 16)
    assert isinstance(c, RWKVState) and c.wkv.shape == (2, toks.shape[0], 4, 16, 16)
    jd = jax.jit(jm.decode_step)
    for t in range(toks.shape[1]):
        jl, jc = jd(jp, jc, jnp.array(toks[:, t : t + 1]))
        logits, c2 = m.decode_step(p, c, torch.tensor(toks[:, t : t + 1], dtype=torch.int64))
        assert c2 is c                                # updated in place
        yield jl, jc, logits, c


def test_decode_steps_match_jax(pair):
    jm, jp, m, p = pair
    for jl, jc, logits, c in _decode_both(jm, jp, m, p, _tokens(7, (2, 10))):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(c.wkv.numpy(), np.asarray(jc.wkv), **STATE_TOL)
        np.testing.assert_allclose(c.shift_t.numpy(), np.asarray(jc.shift_t), **TOL)
        np.testing.assert_allclose(c.shift_c.numpy(), np.asarray(jc.shift_c), **TOL)


def test_decode_continues_the_forward(pair):
    """Stepping the decoder over a sequence gives the forward's logits."""
    _, _, m, p = pair
    toks = torch.tensor(_tokens(4, (2, 12)), dtype=torch.int64)
    full, _ = m.forward(p, {"tokens": toks})
    c = m.init_cache(2, 12)
    for t in range(12):
        logits, c = m.decode_step(p, c, toks[:, t : t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(), **TOL)


def test_quantize_params_exact(pair):
    """rwkv6 quantizes only ``lm_head``: no other leaf name matches."""
    jm, jp, m, p = pair
    jq, q = jquantize_params(jp), quantize_params(p)
    back = params_to_jax(q)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    assert [n for n, _ in tree_flatten_with_names(q) if n.endswith("/q")] == ["lm_head/q"]


def test_quantized_decode_matches_jax(pair):
    """The quantized lm_head goes through fixmatmul's plain version here
    and the Pallas kernel in interpret mode there."""
    jm, jp, m, p = pair
    jq, q = jquantize_params(jp), quantize_params(p)
    for jl, _, logits, _ in _decode_both(jm, jq, m, q, _tokens(11, (2, 8))):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["plain", "quantized"])
def test_greedy_tokens_equal_jax(pair, weights):
    jm, jp, m, p = pair
    if weights == "quantized":
        jp, p = jquantize_params(jp), quantize_params(p)
    jeng = JServeEngine(jm, jp, JServeConfig(), max_len=48)
    eng = ServeEngine(m, p, ServeConfig(), max_len=48)
    ref = jeng.generate(PROMPTS, max_new_tokens=12)
    out = eng.generate(PROMPTS, max_new_tokens=12)
    assert out == ref
    assert [len(o) - len(pr) for o, pr in zip(out, PROMPTS)] == [12] * 3
    assert (eng.stats.prefill_tokens, eng.stats.decode_tokens, eng.stats.steps) == (
        jeng.stats.prefill_tokens, jeng.stats.decode_tokens, jeng.stats.steps)


def test_cli_serves_smoke(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "5",
                           "--new-tokens", "3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[serve] 6 new tokens" in out and "on cpu" in out
