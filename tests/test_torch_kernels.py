"""The PyTorch port's fixmatmul and flash attention against the JAX
package's Pallas kernels (run in interpret mode) on the CPU, where the
port's wrappers take their plain versions.

fixmatmul and ``quantized_matmul`` are exact: int32 sums and the same two
f32 scale multiplies.  Flash attention is held at atol = rtol = 1e-5 in
f32: the two sum the same terms in another order.  In bf16 (the serving
path's type) it is held at atol 1e-2: both round p to bf16 before P V and
the output to bf16 at the end, so a sum taken in another order can move an
output by one bf16 step, 2**-8 = 0.0039 at |x| < 1.

Also on the CPU: fixmatmul's launch planner (which kernel, column tile and
K splits the card gets) and ``refuse_grad``, the kernels' guard against
inputs that require grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import set_kernels
from repro.kernels.fixmatmul.fixmatmul import fixmatmul as jfixmatmul
from repro.kernels.fixmatmul.ops import quantize_weight as jquantize_weight
from repro.kernels.fixmatmul.ops import quantized_matmul as jquantized_matmul
from repro.kernels.flashattn.flashattn import flash_attention as jflash
from repro.kernels.flashattn.ops import attention as jattention

from repro_torch.core.fixedpoint import quantize_per_channel
from repro_torch.kernels.fixmatmul import fixmatmul, fixmatmul_ref, quantize_weight, quantized_matmul
from repro_torch.kernels.fixmatmul.fixmatmul import (BK, MAX_CLUSTER, STREAM_K_STEP, STREAM_MAX_M,
                                                     STREAM_TILES, Plan, k_splits, plan,
                                                     rows_per_thread)
from repro_torch.kernels.flashattn import attention, flash_attention, flash_attention_ref
from repro_torch.kernels.flashattn.flashattn import Route, route
from repro_torch.kernels.grad import refuse_grad

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    set_kernels("interpret")
    yield
    set_kernels("auto")


def _codes(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# fixmatmul
# ---------------------------------------------------------------------------

FIX_SHAPES = [
    # (M, K, N, bm, bn, bk): the JAX package's own kernel-test tiles ...
    (64, 64, 64, 64, 64, 64),
    (128, 256, 64, 64, 64, 64),
    (64, 128, 128, 32, 128, 32),
    (256, 128, 256, 128, 128, 128),
    # ... and ragged shapes, one block each on the JAX side.
    (3, 100, 37, 3, 37, 100),
    (65, 257, 129, 65, 129, 257),
    (1, 1, 1, 1, 1, 1),
    (8, 260, 640, 8, 640, 260),
]


@pytest.mark.parametrize("M,K,N,bm,bn,bk", FIX_SHAPES)
def test_fixmatmul_plain_equals_jax_kernel(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(M * 7919 + K * 31 + N)
    xq, wq = _codes(rng, (M, K)), _codes(rng, (K, N))
    sx = rng.uniform(1e-3, 0.1, M).astype(np.float32)
    sw = rng.uniform(1e-3, 0.1, N).astype(np.float32)
    ref = jfixmatmul(jnp.array(xq), jnp.array(wq), jnp.array(sx), jnp.array(sw),
                     bm=bm, bn=bn, bk=bk, interpret=True)
    out = fixmatmul(*(torch.tensor(a) for a in (xq, wq, sx, sw)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (M, N)
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("code", [-128, 127])
def test_fixmatmul_extreme_codes(code):
    """All codes at one extreme, K = 6912 (danube's d_ff): the largest sums
    the serving path can form."""
    M, K, N = 2, 6912, 64
    xq = np.full((M, K), code, np.int8)
    wq = np.full((K, N), code, np.int8)
    sx = np.full(M, 0.01, np.float32)
    sw = np.linspace(1e-3, 0.1, N).astype(np.float32)
    ref = jfixmatmul(jnp.array(xq), jnp.array(wq), jnp.array(sx), jnp.array(sw),
                     bm=M, bn=N, bk=256, interpret=True)
    out = fixmatmul(*(torch.tensor(a) for a in (xq, wq, sx, sw)))
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lead,K,N", [((3, 17), 192, 120), ((1, 1), 2560 // 10, 640 // 10),
                                      ((5,), 64, 37)])
def test_quantized_matmul_equals_jax(lead, K, N):
    rng = np.random.default_rng(K + N)
    x = rng.normal(size=(*lead, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jwq, jsw = jquantize_weight(jnp.array(w))
    wq, sw = quantize_weight(torch.tensor(w))
    assert np.array_equal(wq.numpy(), np.asarray(jwq))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))
    ref = jquantized_matmul(jnp.array(x), jwq, jsw, bm=64, bn=64, bk=64)
    out = quantized_matmul(torch.tensor(x), wq, sw)
    assert out.shape == tuple(ref.shape)
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_per_channel_equals_jax(axis):
    from repro.core.fixedpoint import quantize_per_channel as jquant

    rng = np.random.default_rng(axis)
    w = (rng.normal(size=(33, 47)) * 3).astype(np.float32)
    w[:, 5] = 0.0                                     # an all-zero channel
    jq, js = jquant(jnp.array(w), bits=8, axis=axis)
    q, s = quantize_per_channel(torch.tensor(w), bits=8, axis=axis)
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


# The decode shapes (K, N) of the serving paths: danube's wq/wo, wk/wv,
# w1/w3, w2 and lm_head, then rwkv6-7b's lm_head.
DECODE_KN = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560), (2560, 32000), (4096, 65536)]
PLAN_CASES = [(1, 2560, 2560), (8, 2560, 640), (8, 2560, 6912), (64, 6912, 2560), (8, 2560, 32000),
              (3, 100, 37)]
PLAN_CASES += [(M, K, N) for K, N in DECODE_KN for M in range(1, STREAM_MAX_M + 2)
               if (M, K, N) not in PLAN_CASES]


@pytest.mark.parametrize("M,K,N", PLAN_CASES)
def test_k_splits_cover_k(M, K, N):
    """The tiled kernel's split of K: whole 64-deep stages that cover K,
    and no more splits than keep the partial sums under a quarter of the
    weight bytes (or one split).  ``plan`` sends M > 16 there and M <= 16
    to the streaming kernel, whose K splits (at most 8: one cluster) put
    every k in exactly one split.  On one H100's 132 SMs it takes the
    widest column tile that can reach half the SMs with 8 splits, and
    splits until the grid has 1.5 blocks an SM or the splits run out; every
    decode shape gets at least half the SMs."""
    sms = 132
    splits, per = k_splits(M, K, N, sms=sms)
    assert per % BK == 0 and splits * per >= K > (splits - 1) * per
    assert splits == 1 or 8 * splits * M * N <= K * N // 4 + 8 * M * N
    p = plan(M, K, N, sms=sms)
    if M > STREAM_MAX_M:
        assert p == Plan("tiled", rows_per_thread(M), splits, per)
        return
    assert p.kernel == "stream" and p.tile in STREAM_TILES and 1 <= p.splits <= MAX_CLUSTER
    assert p.k_per_split % STREAM_K_STEP == 0
    cover = np.zeros(K, np.int64)
    for z in range(p.splits):
        lo, hi = z * p.k_per_split, min(K, (z + 1) * p.k_per_split)
        assert hi > lo                                   # no empty split
        cover[lo:hi] += 1
    assert (cover == 1).all()
    tiles = -(-N // p.tile)
    wider = [t for t in STREAM_TILES if t > p.tile]
    assert all(-(-N // t) * MAX_CLUSTER < sms / 2 for t in wider)
    steps = -(-K // STREAM_K_STEP)
    assert tiles * p.splits >= 1.5 * sms or p.splits == min(MAX_CLUSTER, steps)
    assert tiles * (p.splits - 1) < 1.5 * sms                # no more splits than that
    if (K, N) in DECODE_KN:
        assert tiles * p.splits >= sms / 2


def test_refuse_grad():
    """The kernels' guard: a floating input that requires grad under grad
    mode raises; no_grad and integer tensors pass."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="some_kernel.*no backward"):
        refuse_grad("some_kernel", torch.ones(2), x)
    with torch.no_grad():
        refuse_grad("some_kernel", x)
    refuse_grad("some_kernel", torch.ones(3, dtype=torch.int32), torch.ones(2))
    refuse_grad("some_kernel", x.detach())


def test_fixmatmul_rejects_bad_operands():
    xq = torch.zeros((2, 3), dtype=torch.int8)
    wq = torch.zeros((3, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        fixmatmul(xq, wq[:2], torch.ones(2), torch.ones(4))
    with pytest.raises(ValueError):
        fixmatmul(xq.to(torch.int32), wq, torch.ones(2), torch.ones(4))
    with pytest.raises(ValueError):
        fixmatmul(xq, wq, torch.ones(2, dtype=torch.float64), torch.ones(4))
    assert torch.equal(fixmatmul(xq, wq, torch.ones(2), torch.ones(4)), torch.zeros(2, 4))
    assert fixmatmul_ref(xq, wq, torch.ones(2), torch.ones(4)).dtype == torch.float32


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # (B, H, KV, Sq, Sk, hd, causal, window)
    (2, 4, 2, 128, 128, 32, True, None),
    (1, 4, 4, 128, 128, 64, False, None),
    (2, 8, 2, 256, 256, 32, True, 96),
    (1, 2, 1, 64, 192, 32, False, None),
    (1, 8, 2, 128, 128, 80, True, 8),         # danube: GQA 4, hd 80, a window
    (1, 4, 1, 192, 192, 80, False, 64),
    (1, 2, 2, 64, 64, 128, True, None),
]


def _qkv(rng, B, H, KV, Sq, Sk, hd):
    q = (rng.normal(size=(B, H, Sq, hd)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, KV, Sk, hd)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, KV, Sk, hd)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", FLASH_SHAPES)
def test_flash_plain_matches_jax_kernel(B, H, KV, Sq, Sk, hd, causal, window):
    rng = np.random.default_rng(Sq * 131 + hd)
    q, k, v = _qkv(rng, B, H, KV, Sq, Sk, hd)
    ref = jflash(jnp.array(q), jnp.array(k), jnp.array(v), causal=causal, window=window,
                 bq=64, bk=64, interpret=True)
    out = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    plain = flash_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                causal=causal, window=window)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("Sq,Sk,causal,window", [(100, 100, True, None), (77, 77, True, 8),
                                                 (50, 130, False, None), (130, 130, False, 40)])
def test_attention_op_ragged_matches_jax(Sq, Sk, causal, window):
    """The BSHD op on lengths that are no multiple of a block; the port's
    kernel masks the ragged edge.  The JAX op pads K/V for its kernel,
    which then counts the zero pad keys as keys when the mask is not
    causal, so non-causal cases are held against the JAX plain path."""
    if not causal:
        set_kernels("off")
    rng = np.random.default_rng(Sq + Sk)
    B, H, KV, hd = 1, 4, 2, 80
    q = (rng.normal(size=(B, Sq, H, hd)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Sk, KV, hd)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, Sk, KV, hd)) * 0.5).astype(np.float32)
    ref = jattention(jnp.array(q), jnp.array(k), jnp.array(v), causal=causal, window=window,
                     bq=64, bk=64)
    out = attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal, window=window)
    assert out.shape == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


FLASH_BF16_SHAPES = [
    # danube-like: hd 80, GQA 4, a window (B, H, KV, Sq, Sk, hd, causal, window)
    (1, 8, 2, 128, 128, 80, True, 8),
    (1, 8, 2, 192, 192, 80, True, 100),
    (2, 4, 1, 128, 128, 80, True, None),
]


def _bf16_pair(a):
    """The same bf16 values on both sides (each rounds to nearest even)."""
    return jnp.array(a).astype(jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", FLASH_BF16_SHAPES)
def test_flash_plain_matches_jax_kernel_bf16(B, H, KV, Sq, Sk, hd, causal, window):
    """The plain version (which CUDA kernels are held against on the card)
    against the Pallas kernel, both in bf16; tolerance in the module doc."""
    rng = np.random.default_rng(Sq * 17 + (window or 0))
    (jq, q), (jk, k), (jv, v) = (_bf16_pair(a) for a in _qkv(rng, B, H, KV, Sq, Sk, hd))
    ref = jflash(jq, jk, jv, causal=causal, window=window, bq=64, bk=64, interpret=True)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=0)


def test_attention_op_ragged_matches_jax_bf16():
    """A ragged Sq (no multiple of 64) in bf16 through the BSHD ops, causal
    with a window (the JAX op pads to its blocks; causal masks the pad)."""
    rng = np.random.default_rng(7)
    B, H, KV, S, hd, window = 1, 8, 2, 100, 80, 40
    (jq, q), (jk, k), (jv, v) = (
        _bf16_pair((rng.normal(size=(B, S, n, hd)) * 0.5).astype(np.float32))
        for n in (H, KV, KV))
    ref = jattention(jq, jk, jv, causal=True, window=window, bq=64, bk=64)
    out = attention(q, k, v, causal=True, window=window)
    assert out.shape == tuple(ref.shape) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("hd,hd_pad,copy", [(16, 16, False), (64, 64, False), (72, 80, False),
                                            (80, 80, False), (128, 128, False), (36, 48, True),
                                            (100, 112, True)])
def test_flash_route_bf16_head_dims(hd, hd_pad, copy):
    """bf16 goes to the tensor-core kernel, built for hd rounded up to 16
    (the columns past hd are zeroed in shared memory); a head_dim that is
    no multiple of 8 is copied first into a buffer of roundup(hd, 8)."""
    q = torch.zeros((2, 8, 33, hd), dtype=torch.bfloat16)
    k = torch.zeros((2, 2, 40, hd), dtype=torch.bfloat16)
    assert route(q, k, k) == Route("mma", hd_pad, copy)


def test_flash_route_layouts_and_dtypes():
    z = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    kv = z(1, 2, 8, 80)
    # f32 keeps the FP32-pipe kernel, any strides, no copy.
    f = torch.zeros((1, 4, 8, 84))[..., :80]
    assert route(f, f, f) == Route("fp32", 80, False)
    # The model's BSHD view: strides 2560, 80, 320 — no copy.
    bshd = z(1, 8, 4, 80).movedim(1, 2)
    assert route(bshd, kv, kv) == Route("mma", 80, False)
    # A row stride of 84 values (168 bytes): no 16-byte copy fits it.
    assert route(z(1, 4, 8, 84)[..., :80], kv, kv) == Route("mma", 80, True)
    assert route(bshd, kv, z(1, 2, 8, 84)[..., :80]) == Route("mma", 80, True)
    # A pointer 2 bytes past a 16-byte boundary.
    off = z(4 * 8 * 80 + 1)[1:].view(1, 4, 8, 80)
    assert off.data_ptr() % 16 != 0 and route(off, kv, kv) == Route("mma", 80, True)
    # head_dim not contiguous.
    assert route(z(1, 4, 80, 8).transpose(-1, -2), kv, kv) == Route("mma", 80, True)
    with pytest.raises(ValueError):
        route(*(torch.zeros((1, 1, 8, 16), dtype=torch.float16),) * 3)


def test_flash_rejects_bad_operands():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                       # 4 heads over 3 KV heads
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        flash_attention(q, q.to(torch.float64), q)
