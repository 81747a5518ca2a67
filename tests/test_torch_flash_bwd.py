"""Flash attention's backward on the CPU: which kernel the card would take
(``route`` over q, k, v, out and dout: bf16 aligned operands go to the
tensor-core kernels, f32 to the FP32-pipe ones, bf16 with a row stride of
84 values or head_dim 36 through zero-padded copies), the operands as the
kernel would get them (``bwd_operands``), the shared header of the two
bf16 sources, and the CPU path: ``flash_attention_bwd`` takes the plain
version, launches nothing, and in bf16 gives ``jax.grad`` of the JAX
package's attention within one bf16 step of the largest gradient (1e-2:
the plain version rounds dq, dk and dv to bf16 at the end)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn.ref import flash_attention_ref as jflash_ref

from repro_torch.kernels.flashattn import flashattn as fa
from repro_torch.kernels.flashattn.flashattn import Route, bwd_operands, route
from repro_torch.kernels.flashattn.ref import flash_attention_lse_ref

torch.set_num_threads(1)

B, H, KV, S = 1, 4, 2, 24


def _ops(hd, dtype=torch.bfloat16, wide=None):
    """q, k, v, out, dout at head_dim ``hd``; the operand named by ``wide``
    is a view of rows 84 values apart."""
    shapes = {"q": (B, H, S, hd), "k": (B, KV, S, hd), "v": (B, KV, S, hd),
              "out": (B, H, S, hd), "dout": (B, H, S, hd)}
    g = torch.Generator().manual_seed(hd)
    ops = {}
    for name, sh in shapes.items():
        if name == wide:
            ops[name] = torch.randn((*sh[:3], 84), generator=g).to(dtype)[..., :hd]
        else:
            ops[name] = torch.randn(sh, generator=g).to(dtype)
    return tuple(ops.values())


@pytest.mark.parametrize("hd,hd_pad", [(16, 16), (64, 64), (72, 80), (80, 80), (128, 128)])
def test_bwd_route_bf16_aligned_takes_the_tensor_cores(hd, hd_pad):
    assert route(*_ops(hd)) == Route("mma", hd_pad, False)


def test_bwd_route_bshd_views_take_the_tensor_cores_without_a_copy():
    """The BSHD views that ``ops.attention`` hands the autograd function
    (strides 2560, 80, 320 at 8 heads of 80) need no copy."""
    q, k, v, out, dout = (t.movedim(1, 2).contiguous().movedim(1, 2) for t in _ops(80))
    assert q.stride() != q.contiguous().stride()
    assert route(q, k, v, out, dout) == Route("mma", 80, False)
    ops = bwd_operands(route(q, k, v, out, dout), q, k, v, out, dout)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(ops, (q, k, v, out, dout)))


@pytest.mark.parametrize("wide", [None, "q", "dout"])
def test_bwd_route_f32_takes_the_fp32_kernels(wide):
    assert route(*_ops(80, torch.float32, wide)) == Route("fp32", 80, False)


@pytest.mark.parametrize("wide", ["q", "k", "v", "out", "dout"])
def test_bwd_route_row_stride_84_takes_a_padded_copy(wide):
    """A row stride of 84 values (168 bytes) on any of the five operands:
    no 16-byte copy fits it, so all five are copied."""
    ops = _ops(80, wide=wide)
    r = route(*ops)
    assert r == Route("mma", 80, True)
    padded = bwd_operands(r, *ops)
    for a, t in zip(padded, ops):
        assert a.is_contiguous() and a.shape == t.shape and torch.equal(a, t)


def test_bwd_route_head_dim_36_takes_a_padded_copy():
    """hd 36 is copied into zero-padded rows of 40 (a multiple of 8) and
    runs the HD_PAD 48 instance."""
    ops = _ops(36)
    r = route(*ops)
    assert r == Route("mma", 48, True)
    for a, t in zip(bwd_operands(r, *ops), ops):
        assert a.is_contiguous() and a.shape == (*t.shape[:3], 40)
        assert torch.equal(a[..., :36], t) and not a[..., 36:].any()


def test_bwd_operands_make_head_dim_contiguous():
    """f32 operands with a strided head_dim go to the FP32 kernels as
    contiguous copies; those with a contiguous one stay as they are."""
    ops = _ops(16, torch.float32)
    t = ops[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert t.stride(-1) != 1
    got = bwd_operands(route(t, *ops[1:]), t, *ops[1:])
    assert got[0].stride(-1) == 1 and torch.equal(got[0], t)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(got[1:], ops[1:]))


def test_both_bf16_sources_name_the_shared_header():
    """The forward and the backward share their tensor-core helpers through
    one header, which both libraries list, so an edit rebuilds both."""
    assert fa.MMA_HEADER in fa.TC_LIBRARY.sources
    assert fa.MMA_HEADER in fa.BWD_LIBRARY.sources
    header = (fa.CSRC / fa.MMA_HEADER).read_text()
    for name in ("smem_u32", "cp_async16", "ldsm_x4_t", "void mma(", "ex2", "pack_bf16"):
        assert name in header
    for lib in (fa.TC_LIBRARY, fa.BWD_LIBRARY):
        src = (fa.CSRC / lib.main).read_text()
        assert f'#include "{fa.MMA_HEADER}"' in src and "ldmatrix.sync" not in src


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7), (False, None)])
def test_cpu_bwd_is_jax_grad_and_launches_nothing(causal, window):
    """bf16 on the CPU: the plain version, no kernel counted; its dq, dk
    and dv are ``jax.grad`` of the reference's attention in f32 on the same
    bf16 values, within one bf16 step of the largest."""
    rng = np.random.default_rng(27)
    q, k, v, dout = (rng.normal(size=s).astype(np.float32)
                     for s in ((B, H, S, 16), (B, KV, S, 16), (B, KV, S, 16), (B, H, S, 16)))
    tq, tk, tv, tdo = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v, dout))
    q, k, v, dout = (t.float().numpy() for t in (tq, tk, tv, tdo))

    def f(q, k, v):
        return jnp.sum(jflash_ref(q, k, v, causal=causal, window=window) * dout)

    jgrads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = flash_attention_lse_ref(tq, tk, tv, causal=causal, window=window)
    before = (fa.flash_attention.bwd_launches, fa.flash_attention.bwd_tc_launches)
    grads = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal, window=window)
    assert (fa.flash_attention.bwd_launches, fa.flash_attention.bwd_tc_launches) == before
    for a, b, t in zip(grads, jgrads, (tq, tk, tv)):
        assert a.dtype == torch.bfloat16 and a.shape == t.shape
        b = np.asarray(b)
        assert float(np.abs(a.float().numpy() - b).max()) <= 1e-2 * float(np.abs(b).max())
