"""The PyTorch port's decoder LMs against the JAX package, with the JAX
package's weights carried across by ``params_from_jax``: the
h2o-danube-1.8b SMOKE config (2 layers, d 64, GQA 4/2, head_dim 16, a
sliding window of 8, f32), and the SMOKE configs of starcoder2-7b,
glm4-9b, granite-34b (dense) and qwen2-moe-a2.7b, qwen3-moe-30b-a3b
(moe); and the int8 KV cache.

Tolerances: float logits and caches at atol = rtol = 1e-5, since XLA and
torch take the same f32 sums, roots, sines and cosines in another order
or with another last-bit rounding.  Quantized codes and scales are exact.
Quantized logits too (see ``test_quantized_decode_matches_jax``).  The
int8 KV cache dequantizes in bf16 and casts q and p to bf16 (as the
reference does): from equal inputs its codes and scales are equal byte for
byte; logits are held at INT8_KV_TOL (see ``test_int8_kv_cache_matches_jax``).
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
from repro.config.registry import list_archs
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.models.attention import KVCache as JKVCache
from repro.models.attention import decode_attention as jdecode_attention
from repro.models.quantized import quantization_error as jquantization_error
from repro.models.quantized import quantize_params as jquantize_params

from repro_torch.config import get_arch, get_smoke
from repro_torch.models import build_model
from repro_torch.models.attention import KVCache, decode_attention
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.quantized import quantization_error, quantize_params
from repro_torch.utils.tree import tree_flatten_with_names

torch.set_num_threads(1)

ARCH = "h2o-danube-1.8b"
NEW_ARCHS = ["starcoder2-7b", "glm4-9b", "granite-34b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
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
    """(The name is kept from when the port refused three of the JAX
    package's archs; all ten build now, see below.)  An unknown arch and
    an unknown family still raise."""
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_smoke(ARCH).replace(family="no-such-family"), "cpu")


@pytest.mark.parametrize("arch", list_archs())
def test_every_reference_arch_builds(arch):
    """Every arch of the JAX registry resolves in the port and builds at
    SMOKE on the CPU."""
    cfg = get_smoke(arch)
    assert get_arch(arch).family == cfg.family == jget_smoke(arch).family
    p = build_model(cfg, "cpu").init(0)
    assert p["embed"]["tokens"].shape == (cfg.padded_vocab, cfg.d_model)


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


def test_tree_helpers_match_reference(pair):
    """``tree_size_bytes``, ``tree_num_params``, ``tree_cast`` and
    ``tree_zeros_like`` against ``repro.utils.tree``'s: the sizes over the
    SMOKE params (stacked in the reference, a leaf a layer in the port:
    the same bytes) with an int32 and a bf16 leaf beside them, and over
    shape-only leaves (meta tensors against ShapeDtypeStructs); the cast
    and the zeros leaf by leaf on a tree of equal structure in both (the
    cast leaves the int leaf as it is)."""
    from repro.utils import tree as jtree
    from repro_torch.utils import tree_num_params, tree_size_bytes
    from repro_torch.utils.tree import tree_cast, tree_zeros_like

    jm, jp, m, p = pair
    rng = np.random.default_rng(4)
    leaves = {"w": rng.normal(size=(8, 16)), "half": rng.normal(size=(4, 8)),
              "b": rng.normal(size=(3,))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()} | {
        "step": np.arange(6, dtype=np.int32)}

    def both(half_dtype):
        ours = {"w": torch.tensor(leaves["w"]), "step": torch.tensor(leaves["step"]),
                "nested": {"half": torch.tensor(leaves["half"]).to(half_dtype),
                           "list": [torch.tensor(leaves["b"]), torch.tensor(leaves["w"][0])]}}
        ref = {"w": jnp.array(leaves["w"]), "step": jnp.array(leaves["step"]),
               "nested": {"half": jnp.array(leaves["half"]).astype(str(half_dtype).split(".")[1]),
                          "list": [jnp.array(leaves["b"]), jnp.array(leaves["w"][0])]}}
        return ours, ref

    ours, ref = both(torch.bfloat16)
    assert tree_size_bytes({"params": p, **ours}) == jtree.tree_size_bytes({"params": jp, **ref})
    assert tree_num_params({"params": p, **ours}) == jtree.tree_num_params({"params": jp, **ref})
    meta = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref)
    meta_t = {"w": torch.empty((8, 16), device="meta"),
              "step": torch.empty(6, dtype=torch.int32, device="meta"),
              "nested": {"half": torch.empty((4, 8), dtype=torch.bfloat16, device="meta"),
                         "list": [torch.empty(3, device="meta"), torch.empty(16, device="meta")]}}
    assert tree_size_bytes(meta_t) == jtree.tree_size_bytes(meta) > 0
    assert tree_num_params(meta_t) == jtree.tree_num_params(meta) > 0
    for half in (torch.bfloat16, torch.float32):
        ours, ref = both(half)
        for got, want in ((tree_cast(ours, torch.bfloat16), jtree.tree_cast(ref, jnp.bfloat16)),
                          (tree_cast(ours, torch.float32), jtree.tree_cast(ref, jnp.float32)),
                          (tree_zeros_like(ours), jtree.tree_zeros_like(ref))):
            got = tree_flatten_with_names(got)
            want = jax.tree_util.tree_flatten_with_path(want)[0]
            want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
                    for path, leaf in want}
            assert sorted(n for n, _ in got) == sorted(want)
            for name, leaf in got:
                b = np.asarray(want[name])
                assert str(leaf.dtype).split(".")[-1] == str(b.dtype), name
                assert np.array_equal(leaf.float().numpy(), b.astype(np.float32)), name


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
    """(The name is kept from when the port refused the int8 cache.)  The
    int8 cache is built with the reference's shapes and dtypes: int8 codes,
    f32 scales of ones (B, S, KV, 1) a layer; a float cache has (1, 1, 1,
    1) placeholders; a window caps the length."""
    for arch, kv in ((ARCH, "int8"), (ARCH, "auto"), ("qwen2-moe-a2.7b", "int8")):
        jcfg, cfg = (g(arch).replace(kv_cache_dtype=kv) for g in (jget_smoke, get_smoke))
        jc, c = jbuild_model(jcfg).init_cache(3, 12), build_model(cfg, "cpu").init_cache(3, 12)
        for name in ("k", "v", "ks", "vs"):
            a, b = np.asarray(getattr(jc, name)), getattr(c, name)
            assert tuple(b.shape) == a.shape and str(b.dtype).split(".")[1] == a.dtype.name
            assert np.array_equal(b.numpy(), a)
        assert c.quantized == (kv == "int8") and c.pos == 0 == int(np.asarray(jc.pos)[0])
    assert KVCache.init(1, 4, 2, 8, torch.float32, "cpu").pos == 0


# -- the int8 KV cache --------------------------------------------------------------

# The logits of these SMOKE models stay below 0.75, where one bf16 step
# (2**-8 of a value) is < 3e-3; INT8_KV_TOL is about two such steps.
INT8_KV_TOL = dict(atol=5e-3, rtol=0)


@pytest.mark.parametrize("window", [None, 4])
def test_int8_decode_attention_matches_jax(window):
    """decode_attention on the int8 cache from the same inputs: 10 steps
    (a window of 4 wraps the ring), codes and scales byte for byte after
    every step, the output within a bf16 step."""
    B, S, H, KV, hd = 2, 10 if window is None else 4, 4, 2, 16
    rng = np.random.default_rng(17)
    jc = JKVCache.init(B, S, KV, hd, jnp.int8)
    c = KVCache.init(B, S, KV, hd, torch.int8, "cpu")
    step = jax.jit(jdecode_attention, static_argnames="window")
    for t in range(10):
        q, k, v = (rng.standard_normal((B, 1, n, hd)).astype(np.float32) for n in (H, KV, KV))
        jout, jc = step(jnp.array(q), jnp.array(k), jnp.array(v), jc, window=window)
        out, c = decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), c,
                                  window=window)
        assert c.pos == t + 1 == int(jc.pos)
        for name in ("k", "v", "ks", "vs"):
            a, b = np.asarray(getattr(jc, name)), getattr(c, name).numpy()
            assert b.dtype == a.dtype and np.array_equal(b, a), (t, name)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **INT8_KV_TOL)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_int8_kv_cache_matches_jax(arch):
    """The whole model on the int8 cache, 10 steps (danube's window-8 ring
    wraps; qwen2-moe's cache is full).  The cached k/v are computed by each
    framework's own f32 sums, so a scale may differ in its last bit and a
    code by one step where x / scale sits on a rounding edge; the logits
    pass bf16-rounded q and p, where a last-bit difference moves a value by
    one bf16 step (2**-8 of it): INT8_KV_TOL holds them.  (The scale is
    the reference's as jitted: XLA turns ``absmax / 127.0`` into a product
    with the f32 reciprocal, and so does the port.)"""
    jcfg, cfg = (g(arch).replace(kv_cache_dtype="int8") for g in (jget_smoke, get_smoke))
    jm, m = jbuild_model(jcfg), build_model(cfg, "cpu")
    jp = jm.init(jax.random.key(1))
    p = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(21, (2, 10))
    for t, jl, jc, logits, c in _decode_both(jm, jp, m, p, toks, cache_len=16):
        assert c.k.dtype == torch.int8 and c.ks.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **INT8_KV_TOL)
        np.testing.assert_allclose(c.ks.numpy(), np.asarray(jc.ks), **TOL)
        np.testing.assert_allclose(c.vs.numpy(), np.asarray(jc.vs), **TOL)
        for name in ("k", "v"):
            d = np.abs(getattr(c, name).numpy().astype(np.int32) - np.asarray(getattr(jc, name)))
            assert d.max() <= 1 and (d == 0).mean() > 0.99, (t, name)


# -- the new configs: starcoder2-7b, glm4-9b, granite-34b, qwen2-moe, qwen3-moe -------

@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_pair(request):
    arch = request.param
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(2))
    m = build_model(cfg, "cpu")
    return arch, jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_config_equals_reference(arch):
    assert dataclasses.asdict(get_smoke(arch)) == dataclasses.asdict(jget_smoke(arch))
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(jget_arch(arch))
    full = build_model(get_arch(arch), "cpu").cfg
    assert full.head_dim == 128 and (full.family == "moe") == arch.startswith("qwen")


def test_granite_keeps_the_gated_mlp():
    """The reference's granite-34b config keeps the default gated MLP: 47.2 B
    parameters, not the 34 B its name says; the port copies it as it is."""
    c = get_arch("granite-34b")
    assert c.mlp_gated and not c.use_bias and not c.tie_embeddings
    layer = 2 * c.d_model * (c.q_dim + c.kv_dim) + 3 * c.d_model * c.d_ff + 2 * c.d_model
    total = c.num_layers * layer + 2 * c.padded_vocab * c.d_model + c.d_model
    assert round(total / 1e9, 1) == 47.2


def test_new_params_round_trip(arch_pair):
    arch, jm, jp, m, p = arch_pair
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    if "moe" in p["layers"][0]:
        cfg = m.cfg
        mp = p["layers"][1]["moe"]
        assert mp["w1"].shape == (cfg.num_expert_slots, cfg.d_model, cfg.moe_d_ff)
        assert mp["router"].dtype == torch.float32
        assert ("shared" in mp) == (cfg.num_shared_experts > 0)


def test_new_forward_matches_jax(arch_pair):
    arch, jm, jp, m, p = arch_pair
    toks = _tokens(5, (2, 12))
    jl, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.array(toks)})
    logits, aux = m.forward(p, {"tokens": torch.tensor(toks, dtype=torch.int64)})
    assert logits.shape == (2, 12, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == arch.startswith("qwen")


def test_new_decode_steps_match_jax(arch_pair):
    arch, jm, jp, m, p = arch_pair
    toks = _tokens(6, (2, 8))
    for t, jl, jc, logits, c in _decode_both(jm, jp, m, p, toks, cache_len=12):
        assert c.pos == t + 1 and c.k.shape == np.asarray(jc.k).shape
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), **TOL)


def test_new_quantized_leaves_match_jax(arch_pair):
    """quantize_params quantizes exactly the reference's leaves: attention
    and dense MLP projections and lm_head; never the experts, the shared
    experts or the router, which stay float on both sides."""
    arch, jm, jp, m, p = arch_pair
    jq, q = jquantize_params(jp), quantize_params(p)
    back = params_to_jax(q)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    names = {re.sub(r"^layers/\d+/", "layers/", n) for n in quantization_error(p, q)}
    assert names == set(jquantization_error(jp, jq))
    if arch.startswith("qwen"):
        assert names == {f"layers/attn/{w}" for w in ("wq", "wk", "wv", "wo")} | {"lm_head"}
        assert torch.equal(q["layers"][0]["moe"]["w1"], p["layers"][0]["moe"]["w1"])


def test_new_quantized_int8_kv_decode_matches_jax(arch_pair):
    """The serving path: int8 weights and the int8 KV cache together."""
    arch, jm, jp, m, p = arch_pair
    jcfg, cfg = (g(arch).replace(kv_cache_dtype="int8") for g in (jget_smoke, get_smoke))
    jm8, m8 = jbuild_model(jcfg), build_model(cfg, "cpu")
    toks = _tokens(8, (2, 6))
    for _, jl, jc, logits, c in _decode_both(jm8, jquantize_params(jp), m8, quantize_params(p),
                                             toks, cache_len=8):
        assert c.k.dtype == torch.int8
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **INT8_KV_TOL)
