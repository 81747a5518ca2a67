"""The PyTorch port's mixture of experts (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe``, on inputs drawn with a
numpy seed: the sort-based capacity dispatch with groups, padded expert
slots, shared experts and dropped assignments (decode-sized batches of
the full configs' routing, where each expert takes one token), routers
with tied columns, the dense oracle, and the aux loss.

Tolerance: y and aux at atol = rtol = 1e-5 in f32 (XLA and torch sum the
same products in another order); the routing (ids) is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch.models import moe

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, S, D, F, E, Ep, k, capacity_factor, groups, shared F or 0); every
# case but the two dropless ones drops assignments
DROPLESS = {"dropless", "smoke_padded"}
CASES = {
    "dropless": (4, 16, 32, 16, 8, 8, 2, 16.0, 1, 0),
    "drops": (4, 16, 32, 16, 8, 8, 2, 0.5, 1, 0),
    "drops_groups2": (4, 16, 32, 16, 8, 8, 2, 0.5, 2, 0),
    "drops_groups4_padded_shared": (4, 16, 32, 16, 8, 10, 2, 0.75, 4, 24),
    "smoke_padded": (2, 12, 64, 48, 8, 10, 4, 4.0, 1, 96),   # qwen2-moe SMOKE: 8 -> 10 slots
    "decode_qwen2_routing": (8, 1, 32, 16, 60, 64, 4, 1.25, 1, 32),   # C = 1
    "decode_qwen3_routing": (8, 1, 32, 16, 128, 128, 8, 1.25, 1, 0),  # C = 1
}


def _np_params(seed, D, F, E, Ep, shared_f):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": n(D, E), "w1": n(Ep, D, F), "w3": n(Ep, D, F), "w2": n(Ep, F, D)}
    sh = {"w1": n(D, shared_f), "w3": n(D, shared_f), "w2": n(shared_f, D)} if shared_f else None
    return p, sh


def _both(tree):
    """One copy of a numpy tree for each framework."""
    if tree is None:
        return None, None
    return ({k: jnp.array(v) for k, v in tree.items()},
            {k: torch.tensor(v) for k, v in tree.items()})


@pytest.fixture(scope="module")
def jsorted():
    return jax.jit(jmoe.moe_sorted, static_argnames=("num_experts", "top_k", "act",
                                                    "capacity_factor", "groups"))


def _capacity(Ng, k, cf, E):
    return max(int((Ng * k * cf + E - 1) // E), 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_sorted_matches_jax(case, jsorted):
    B, S, D, F, E, Ep, k, cf, groups, shared_f = CASES[case]
    p, sh = _np_params(len(case), D, F, E, Ep, shared_f)
    x = np.random.default_rng(7).standard_normal((B, S, D)).astype(np.float32)
    (jp, tp), (jsh, tsh) = _both(p), _both(sh)
    kw = dict(num_experts=E, top_k=k, capacity_factor=cf, groups=groups)
    ref = jsorted(jnp.array(x), jp, act=jax.nn.silu, shared=jsh, **kw)
    out = moe.moe_sorted(torch.tensor(x), tp, act=torch.nn.functional.silu, shared=tsh, **kw)
    assert out.y.shape == (B, S, D) and out.y.dtype == torch.float32
    np.testing.assert_allclose(out.y.numpy(), np.asarray(ref.y), **TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(ref.aux_loss), **TOL)

    # How many assignments the capacity drops: none only in the dropless cases.
    Ng = B * S // groups
    _, ids, _ = moe.router_topk(torch.tensor(x).reshape(groups, Ng, D), tp["router"], k)
    per_expert = torch.stack([torch.bincount(g.reshape(-1), minlength=E) for g in ids])
    dropped = int(torch.clamp(per_expert - _capacity(Ng, k, cf, E), min=0).sum())
    assert (dropped == 0) == (case in DROPLESS), dropped
    if case.startswith("decode"):
        assert _capacity(Ng, k, cf, E) == 1


def test_padded_slots_are_never_routed(jsorted):
    """Padded slots hold huge weights; the output equals the unpadded one."""
    B, S, D, F, E, Ep, k, cf, groups, _ = CASES["drops_groups2"]
    p, _ = _np_params(3, D, F, E, Ep, 0)
    x = torch.tensor(np.random.default_rng(8).standard_normal((B, S, D)).astype(np.float32))
    tp = {key: torch.tensor(v) for key, v in p.items()}
    padded = {"router": tp["router"], **{key: torch.cat([tp[key], torch.full(
        (3,) + tp[key].shape[1:], 7.0)]) for key in ("w1", "w3", "w2")}}
    kw = dict(num_experts=E, top_k=k, act=torch.nn.functional.silu, capacity_factor=cf,
              groups=groups)
    a, b = moe.moe_sorted(x, tp, **kw), moe.moe_sorted(x, padded, **kw)
    assert torch.equal(a.y, b.y) and torch.equal(a.aux_loss, b.aux_loss)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tied_router_columns_take_the_lower_index(k, jsorted):
    """Columns 2 and 5 of the router are equal and dominant, and columns
    0, 1, 3 equal each other: top-k must list 2 before 5 and the lower of
    equal values first, as ``jax.lax.top_k`` does, and route the same."""
    D, E = 16, 6
    rng = np.random.default_rng(11)
    w = rng.standard_normal((D, E)).astype(np.float32) * 0.1
    w[:, 5] = w[:, 2] = np.abs(w[:, 2]) + 1.0
    w[:, 1] = w[:, 3] = w[:, 0]
    x = np.abs(rng.standard_normal((3, 4, D))).astype(np.float32)
    jw, jids, jprobs = jmoe.router_topk(jnp.array(x.reshape(12, D)), jnp.array(w), k)
    tw, tids, tprobs = moe.router_topk(torch.tensor(x.reshape(12, D)), torch.tensor(w), k)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert (tids[:, 0] == 2).all() and (k < 2 or (tids[:, 1] == 5).all())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    # all columns equal: the first k experts, in order
    _, ids0, _ = moe.router_topk(torch.tensor(x.reshape(12, D)), torch.zeros(D, E), k)
    assert ids0.tolist() == [list(range(k))] * 12

    p, _ = _np_params(5, D, 8, E, E, 0)
    p["router"] = w
    jp, tp = _both(p)
    kw = dict(num_experts=E, top_k=k, capacity_factor=1.0, groups=1)
    ref = jsorted(jnp.array(x), jp, act=jax.nn.silu, **kw)
    out = moe.moe_sorted(torch.tensor(x), tp, act=torch.nn.functional.silu, **kw)
    np.testing.assert_allclose(out.y.numpy(), np.asarray(ref.y), **TOL)


@pytest.mark.parametrize("shared_f", [0, 24])
def test_dense_ref_matches_jax(shared_f):
    B, S, D, F, E, Ep, k = 2, 8, 32, 16, 8, 8, 2
    p, sh = _np_params(13, D, F, E, Ep, shared_f)
    x = np.random.default_rng(9).standard_normal((B, S, D)).astype(np.float32)
    (jp, tp), (jsh, tsh) = _both(p), _both(sh)
    ref = jmoe.moe_dense_ref(jnp.array(x), jp, num_experts=E, top_k=k, act=jax.nn.silu,
                             shared=jsh)
    out = moe.moe_dense_ref(torch.tensor(x), tp, num_experts=E, top_k=k,
                            act=torch.nn.functional.silu, shared=tsh)
    np.testing.assert_allclose(out.y.numpy(), np.asarray(ref.y), **TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(ref.aux_loss), **TOL)
    # dropless dispatch equals the dense oracle
    srt = moe.moe_sorted(torch.tensor(x), tp, num_experts=E, top_k=k,
                         act=torch.nn.functional.silu, capacity_factor=16.0, shared=tsh)
    np.testing.assert_allclose(srt.y.numpy(), out.y.numpy(), **TOL)


def test_load_balance_loss_matches_jax():
    N, E, k = 64, 8, 2
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(E), N).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(N)]).astype(np.int32)
    ref = jmoe.load_balance_loss(jnp.array(probs), jnp.array(ids), E)
    out = moe.load_balance_loss(torch.tensor(probs), torch.tensor(ids, dtype=torch.int64), E)
    np.testing.assert_allclose(float(out), float(ref), **TOL)
    uniform = moe.load_balance_loss(torch.full((N, E), 1.0 / E),
                                    torch.stack([torch.arange(N) % E, (torch.arange(N) + 1) % E], 1), E)
    assert float(uniform) == pytest.approx(1.0, rel=1e-6)
