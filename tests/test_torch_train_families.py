"""Every family's train step against the JAX package on the CPU: two SGD
steps in f32 of the SMOKE configs of qwen2-moe-a2.7b and qwen3-moe-30b-a3b
(moe: the router's aux loss in the gradient), zamba2-1.2b (hybrid),
whisper-tiny (encdec: stub frames in ``frontend``) and internvl2-2b (vlm:
stub patches in ``frontend``), from the reference's weights
(``params_from_jax``) on batches drawn with numpy from a seed, against
``jax.jit(repro.train.train_step.make_train_step)``; and the routing
replay of ``chip_smoke.py`` phase 13 (a) (``RouterProbe``) on the port
alone.

The tolerances are ``tests/test_torch_train.py``'s
``test_tiny_train_steps_match_jax``: SGD, whose update is linear in the
gradient; loss, ce, aux and grad_norm within 1e-5 relative each step;
every param within 1e-5 of its leaf's largest value.  To that one floor
is added, 1e-9 absolute, for the leaves that start at zero and so hold
the steps' updates alone: whisper's attention key biases, whose gradient
is zero but for rounding (a bias added to every key moves all of a
query's scores alike), sit near 2e-11 in both frameworks, with no common
digit; zamba2's ``dt_bias`` (values near 1e-5) agrees to 1.1e-5 of its
largest value after two steps, its step-1 gradient to 2.4e-6.  The
floor is 1e-4 of the smallest of those leaves' values and ~5e-6 of the
smallest update of any other leaf.

An MoE step routes each token to its top-k experts: a near-tie between
the k-th and the (k+1)-th router logit would let the two frameworks' last
bits pick different experts, and a comparison of the steps would then
pass or fail by luck.  So the MoE cases hold the routing itself: the
reference's expert ids come out of its jitted step through an ordered
``jax.debug.callback`` on ``jax.lax.top_k`` (patched for the trace), and
every router call's ids must equal the port's, in call order (each
layer's forward, then its recompute under remat).  The smallest top-k
logit gap over the port's calls is measured and named in every failure;
with seed 0 it is 4.2e-5 (qwen2-moe, step 2, layer 0) and 1.9e-4
(qwen3-moe, step 1, layer 0), while the two frameworks' router
probabilities (up to 0.19) differ by at most 7.5e-8.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.train import train_step as jts

from repro_torch.config import TrainConfig, get_smoke
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import optimizer
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step
from repro_torch.utils.tree import tree_flatten_with_names, tree_map

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-tiny", "internvl2-2b"]
B, S, STEPS = 2, 16, 2
TKW = dict(lr=0.2, warmup_steps=2, total_steps=50, optimizer="sgd")
REL, FLOOR = 1e-5, 1e-9


@pytest.fixture(autouse=True)
def _plain_jax_attention():
    """The reference trains through its plain blocked attention on the CPU
    (its Pallas kernel has no VJP)."""
    set_kernels("auto")
    yield


def _batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if cfg.family in ("encdec", "vlm"):
            t, d = (cfg.encoder_ctx, cfg.d_model) if cfg.family == "encdec" else \
                (cfg.vision_tokens, cfg.vision_dim)
            b["frontend"] = rng.normal(size=(B, t, d)).astype(np.float32)
        out.append(b)
    return out


def _named(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_two_sgd_steps_match_jax(arch, monkeypatch):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    gaps, ids, jids = [], [], []
    if cfg.family == "moe":
        router_topk, top_k = moe_mod.router_topk, jax.lax.top_k

        def routed(x, w, k):
            top = torch.topk((x.float() @ w.float()).detach(), k + 1, dim=-1).values
            gaps.append(float((top[..., k - 1] - top[..., k]).min()))
            out = router_topk(x, w, k)
            ids.append(out[1].numpy().copy())
            return out

        def jrouted(x, k):
            out = top_k(x, k)
            jax.debug.callback(lambda i: jids.append(np.asarray(i).copy()), out[1], ordered=True)
            return out

        monkeypatch.setattr(moe_mod, "router_topk", routed)
        monkeypatch.setattr(jax.lax, "top_k", jrouted)
    jtc, tc = JTrainConfig(**TKW), TrainConfig(**TKW)
    jmodel, model = jbuild_model(jcfg), build_model(cfg, "cpu")
    jstate = jts.init_train_state(jmodel, jtc, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    init, _ = optimizer.make_optimizer(tc)
    state = TrainState(params, init(params), torch.Generator().get_state(),
                       torch.zeros((), dtype=torch.int32))
    jstep, step = jax.jit(jts.make_train_step(jmodel, jtc)), make_train_step(model, tc)
    metrics = []
    for b in _batches(cfg):
        jstate, jm = jstep(jstate, {k: jnp.array(v) for k, v in b.items()})
        state, m = step(state, {k: torch.tensor(v) for k, v in b.items()})
        metrics.append((jm, m))
    if cfg.family == "moe":
        # every layer's router, forward and recompute, both steps
        assert len(ids) == len(jids) == 2 * STEPS * cfg.num_layers
        for i, (a, b) in enumerate(zip(ids, jids)):
            assert np.array_equal(a, b), \
                f"router call {i}: the experts differ (smallest top-k logit gap {min(gaps):.3g})"
    for i, (jm, m) in enumerate(metrics):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=REL), (i, k)
        assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    assert int(state.step) == STEPS
    ours = dict(tree_flatten_with_names(params_to_jax(state.params)))
    ref = _named(jstate.params)
    assert ours.keys() == ref.keys()
    for key, b in ref.items():
        assert np.abs(ours[key] - b).max() <= REL * np.abs(b).max() + FLOOR, key


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_routing_replay_reproduces_the_step():
    """``chip_smoke.py`` phase 13 (a)'s replay: one AdamW step of the
    qwen2-moe SMOKE config (remat, so each layer's router runs twice) with
    its expert ids recorded, then the same step from a copy of the same
    state replaying them: no assignment routed apart, and the loss, aux,
    grad_norm and every updated param and moment equal bit for bit.
    Replaying them over another batch does route apart, and moves the
    loss: the replay takes the ids it is given, not its own."""
    probe = _chip_smoke().RouterProbe(torch, moe_mod)
    cfg = get_smoke("qwen2-moe-a2.7b")
    tc = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model = build_model(cfg, "cpu")
    step = make_train_step(model, tc)
    first = init_train_state(model, tc, 0)
    copy = lambda: TrainState(tree_map(lambda t: t.detach().clone(), first.params),
                              tree_map(lambda t: t.detach().clone(), first.opt), first.rng,
                              first.step.clone())
    states = [copy(), copy()]
    b0, b1 = ({k: torch.tensor(v) for k, v in b.items()} for b in _batches(cfg, seed=3))
    with probe.record():
        states[0], m0 = step(states[0], b0)
    with probe.replay():
        states[1], m1 = step(states[1], b0)
    assert probe.last == {"router_calls": 2 * cfg.num_layers, "routed_apart": 0,
                          "assignments": 2 * cfg.num_layers * B * S * cfg.num_experts_per_tok}
    for k in ("loss", "aux", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    for (name, a), (_, b) in zip(tree_flatten_with_names(states[0]),
                                 tree_flatten_with_names(states[1])):
        assert torch.equal(a, b), name
    assert moe_mod.router_topk is probe.router_topk and moe_mod._dispatch is probe.dispatch
    with probe.replay():
        _, m2 = step(copy(), b1)
    _, own = step(copy(), b1)
    assert probe.last["routed_apart"] > 0 and float(m2["loss"]) != float(own["loss"])
