"""The port's training path against the JAX package on the CPU: the LR
schedules, AdamW / Lion / SGD, clipping, int8 gradient compression, the
data pipeline, the loss, three train steps of ``tests/test_train.py``'s
TINY config (plain, ``microbatches=4``, ``grad_compression="int8_ef"``)
with the reference's weights carried over, one bf16 step of the
h2o-danube-1.8b SMOKE config, the Trainer's save/restore, the launcher,
``param_count`` for every arch, and flash attention's plain backward
against ``jax.grad`` of the reference's attention.

Tolerances are written at each test.  In f32 the two frameworks take the
same sums in another order (and XLA's pow and cos may differ from numpy's
in the last bit), so values agree to ~1e-6 relative; where AdamW's
normalisation g / sqrt(v) turns such a difference into an update, the
bound is stated in units of the learning rate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.kernels.flashattn.ref import flash_attention_ref as jflash_ref
from repro.models import build_model as jbuild_model
from repro.models.counting import active_param_count as jactive_count
from repro.models.counting import param_count as jparam_count
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig, get_arch, get_smoke
from repro_torch.kernels.flashattn import FlashAttention
from repro_torch.kernels.flashattn.ops import attention as flash_op
from repro_torch.kernels.flashattn.ref import flash_attention_bwd_ref, flash_attention_lse_ref
from repro_torch.models import build_model
from repro_torch.models.attention import blocked_attention
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import compression, data, optimizer
from repro_torch.train.train_step import TrainState, init_train_state, loss_fn, make_train_step
from repro_torch.utils.tree import tree_flatten_with_names

torch.set_num_threads(1)

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
               num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
ARCHS = ["h2o-danube-1.8b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "starcoder2-7b", "glm4-9b",
         "granite-34b", "rwkv6-7b", "zamba2-1.2b", "whisper-tiny", "internvl2-2b"]


@pytest.fixture(autouse=True)
def _plain_jax_attention():
    """The reference trains through its plain blocked attention on the CPU
    (its Pallas kernel has no VJP)."""
    set_kernels("auto")
    yield


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- schedules, optimizers, clipping -------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_lr_schedule_matches(schedule):
    """Within 1e-6 relative (f32 division, cos)."""
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, lr_schedule=schedule)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    for s in [0, 1, 5, 10, 11, 37, 50, 99, 100, 120]:
        ref = float(jopt.lr_schedule(jcfg, jnp.int32(s)))
        assert optimizer.lr_schedule(cfg, s) == pytest.approx(ref, rel=1e-6, abs=1e-12), s


def _opt_tree(rng, dtype):
    return {"w": rng.normal(size=(8, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "lion", "sgd"])
def test_optimizer_three_updates_match(name, dtype):
    """Three updates from the same params and grads (clipped at a norm the
    grads exceed).  f32 params within 1e-5 relative of the largest value
    (Lion's sign is exact; AdamW's and SGD's f32 sums agree to the last
    bits); bf16 params within one bf16 step of it (2^-8), since a last-bit
    difference of the f32 update can move the rounding to bf16; the
    moments (f32) within 1e-5 relative."""
    rng = np.random.default_rng(0)
    kw = dict(lr=0.05, optimizer=name, warmup_steps=1, total_steps=10, grad_clip=2.0)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    p0 = _opt_tree(rng, dtype)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jinit, jupd = jopt.make_optimizer(jcfg)
    init, upd = optimizer.make_optimizer(cfg)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = {k: torch.tensor(v).to(tdt) for k, v in p0.items()}
    jo, to = jinit(jp), init(tp)
    for g in grads:
        jp, jo, jm = jupd(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jo)
        tp, to, tm = upd(cfg, tp, {k: torch.tensor(v) for k, v in g.items()}, to)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(to.step) == int(jo.step) == 3
    tol = 2.0 ** -8 if dtype == "bfloat16" else 1e-5
    for k in p0:
        assert tp[k].dtype == tdt
        assert _rel(_np(tp[k]), np.asarray(jp[k], np.float32)) <= tol, k
        if name != "sgd":
            assert _rel(_np(to.m[k]), np.asarray(jo.m[k])) <= 1e-5, k
        if name == "adamw":
            assert _rel(_np(to.v[k]), np.asarray(jo.v[k])) <= 1e-5, k


def test_clip_by_global_norm_matches():
    """The norm and the clipped leaves within 1e-6 relative."""
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(30, 7)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.5)
    tc, tn = optimizer.clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()}, 1.5)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in g:
        assert tc[k].dtype == torch.float32
        assert _rel(_np(tc[k]), np.asarray(jc[k])) <= 1e-6


def test_compression_matches_jitted_reference():
    """The dequantized gradients byte for byte against the reference under
    jit (its scale is absmax times the f32 reciprocal of 127 there), with
    and without error feedback, on leaves of 1, 2047, 2048 and 5000
    values.  The residual x - q * scale within one f32 spacing of the
    dequantized value: XLA on the CPU contracts it into one fused
    multiply-add, which skips the rounding of q * scale."""
    rng = np.random.default_rng(2)
    g = {f"g{n}": (rng.normal(size=(n,)) * 1e-3).astype(np.float32) for n in (1, 2047, 2048, 5000)}
    g["m"] = rng.normal(size=(40, 70)).astype(np.float32)
    e = {k: (rng.normal(size=v.shape) * 1e-5).astype(np.float32) for k, v in g.items()}
    jg, tg = ({k: f(v) for k, v in g.items()} for f in (jnp.asarray, torch.tensor))
    je, te = ({k: f(v) for k, v in e.items()} for f in (jnp.asarray, torch.tensor))
    jout = jax.jit(jcomp.compress_decompress_grads)(jg)
    tout = compression.compress_decompress_grads(tg)
    jdec, jres = jax.jit(jcomp.compress_decompress_with_feedback)(jg, je)
    tdec, tres = compression.compress_decompress_with_feedback(tg, te)
    for k in g:
        assert np.array_equal(_np(tout[k]), np.asarray(jout[k])), k
        assert np.array_equal(_np(tdec[k]), np.asarray(jdec[k])), k
        spacing = np.spacing(np.abs(np.asarray(jdec[k])))
        assert np.all(np.abs(_np(tres[k]) - np.asarray(jres[k])) <= spacing), k
    assert all(np.array_equal(_np(v), np.zeros(g[k].shape))
               for k, v in compression.init_residual(tg).items())


# -- data -----------------------------------------------------------------------------

def test_data_pipeline_byte_equal(tmp_path):
    """SyntheticLM and FileTokens batches, host shards and a pipeline
    resumed from ``state_dict``: byte-equal to the reference's."""
    for kw in (dict(vocab_size=128, seq_len=32, global_batch=4, seed=7),
               dict(vocab_size=500, seq_len=8, global_batch=8, seed=1, host_id=1, num_hosts=2)):
        ref, port = jdata.SyntheticLM(jdata.DataConfig(**kw)), data.SyntheticLM(data.DataConfig(**kw))
        for step in (0, 1, 17):
            a, b = ref.batch_at(step), port.batch_at(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 1000, 4096).astype(np.int32).tofile(path)
    kw = dict(vocab_size=300, seq_len=16, global_batch=4, seed=2, source="file", path=str(path))
    a = jdata.FileTokens(jdata.DataConfig(**kw)).batch_at(3)
    b = data.FileTokens(data.DataConfig(**kw)).batch_at(3)
    assert np.array_equal(a["tokens"], b["tokens"]) and np.array_equal(a["labels"], b["labels"])

    kw = dict(vocab_size=128, seq_len=32, global_batch=4, seed=7)
    ref, port = jdata.DataPipeline(jdata.DataConfig(**kw)), data.DataPipeline(data.DataConfig(**kw))
    for _ in range(3):
        assert np.array_equal(ref.next_batch()["tokens"], port.next_batch()["tokens"])
    state = port.state_dict()
    assert state == ref.state_dict() == {"step": 3, "seed": 7}
    port.close()
    resumed = data.DataPipeline(data.DataConfig(**kw))
    resumed.load_state_dict(state)
    assert np.array_equal(resumed.next_batch()["labels"], ref.next_batch()["labels"])
    resumed.close()
    ref.close()
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    pipe = data.pipeline_for(get_smoke("h2o-danube-1.8b"), shape, seed=4)
    assert pipe.cfg.vocab_size == get_smoke("h2o-danube-1.8b").vocab_size
    assert pipe.source.batch_at(0)["tokens"].shape == (2, 16)


# -- loss and train steps ---------------------------------------------------------------

class _Fixed:
    """A model whose forward returns given logits and aux."""

    def __init__(self, cfg, logits, aux):
        self.cfg, self.logits, self.aux = cfg, logits, aux

    def forward(self, params, batch, **kw):
        return self.logits, self.aux


def test_loss_fn_matches():
    """CE, z-loss, the MoE aux term and the total on the same logits, some
    labels masked (-1): within 1e-6 relative."""
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    labels[0, :4] = -1
    kw = dict(TINY_KW, family="moe", num_experts=4, num_experts_per_tok=2)
    tcfg = dict(z_loss=1e-3)
    jt, jm = jts.loss_fn(_Fixed(JModelConfig(**kw), jnp.asarray(logits), jnp.float32(0.7)),
                         JTrainConfig(**tcfg), None, {"labels": jnp.asarray(labels)})
    tt, tm = loss_fn(_Fixed(ModelConfig(**kw), torch.tensor(logits), torch.tensor(0.7)),
                     TrainConfig(**tcfg), None, {"labels": torch.tensor(labels)})
    assert float(tt) == pytest.approx(float(jt), rel=1e-6)
    for k in ("ce", "z_loss", "aux"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k


def _batches(vocab, B, S, n, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, B, S + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:].copy()} for t in toks]


def _run_both(jcfg, cfg, tkw, batches, *, device="cpu"):
    """The reference's jitted steps and the port's from the same weights."""
    jtc, tc = JTrainConfig(**tkw), TrainConfig(**tkw)
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device)
    jstate = jts.init_train_state(jmodel, jtc, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, device)
    init, _ = optimizer.make_optimizer(tc)
    state = TrainState(params, init(params), torch.Generator().get_state(),
                       torch.zeros((), dtype=torch.int32))
    jstep, step = jax.jit(jts.make_train_step(jmodel, jtc)), make_train_step(model, tc)
    out = []
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((jm, m))
    return jstate, state, out


@pytest.mark.parametrize("extra", [{}, {"microbatches": 4}, {"grad_compression": "int8_ef"}],
                         ids=["plain", "microbatches4", "int8_ef"])
def test_tiny_train_steps_match_jax(extra):
    """Three steps of the TINY config (f32, remat) from the reference's
    weights on the same batches, with SGD, whose update is linear in the
    gradient (AdamW's g / sqrt(v) turns a last-bit difference of a tiny
    gradient into one of up to 2 lr, and three steps carry that on; the
    danube step below holds AdamW).  The step-1 gradients agree to ~1e-6
    of the largest.  Loss, CE and grad_norm within 1e-5 relative each step;
    every param within 1e-5 of the largest param value, and with int8_ef
    within one quantization step (lr * max|g| / 127 a step) more, since a
    last-bit difference can move a value across a rounding edge."""
    tkw = dict(lr=0.2, warmup_steps=2, total_steps=50, optimizer="sgd", **extra)
    jstate, state, out = _run_both(JModelConfig(**TINY_KW), ModelConfig(**TINY_KW), tkw,
                                   _batches(256, 8, 32, 3))
    for jm, m in out:
        for k in ("loss", "ce", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert int(state.step) == 3
    quant = 3 * tkw["lr"] * max(float(jm["grad_norm"]) for jm, _ in out) / 127
    ref = dict(tree_flatten_with_names(params_to_jax(state.params)))
    for name, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        key = "/".join(str(p.key) for p in name)
        b = np.asarray(leaf)
        tol = 1e-5 * np.abs(b).max() + (quant if extra.get("grad_compression") else 0.0)
        assert np.abs(ref[key] - b).max() <= tol, key


def test_danube_smoke_bf16_step_matches_jax():
    """One AdamW step of the h2o-danube-1.8b SMOKE config in bf16 (2
    layers, d 64, GQA 4/2, a window of 8), from the reference's weights.
    bf16 activations round at other places in the two frameworks: the loss
    within 1e-2 relative, grad_norm within 5e-2; a param's step-1 update is
    lr * g / (|g| + eps), about lr * sign(g), so each param lies within
    2 lr plus the bf16 rounding of both results (2^-8 of each) of the
    reference's, and 99% of them within that rounding alone."""
    jcfg = jget_smoke("h2o-danube-1.8b").replace(dtype="bfloat16")
    cfg = get_smoke("h2o-danube-1.8b").replace(dtype="bfloat16")
    tkw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstate, state, [(jm, m)] = _run_both(jcfg, cfg, tkw, _batches(cfg.vocab_size, 2, 16, 1))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-2)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=5e-2)
    ref = dict(tree_flatten_with_names(params_to_jax(state.params)))
    close = total = 0
    for name, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        key = "/".join(str(p.key) for p in name)
        a, b = ref[key], np.asarray(leaf, np.float32)
        step = 2.0 ** -8 * (np.abs(a) + np.abs(b))
        assert np.all(np.abs(a - b) <= 2 * tkw["lr"] + step + 1e-12), key
        close += int(np.sum(np.abs(a - b) <= step + 1e-12))
        total += b.size
    assert close >= 0.99 * total


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                                  "whisper-tiny", "internvl2-2b", "rwkv6-7b"])
def test_remat_checkpoints_each_layer_and_keeps_the_gradients(arch, monkeypatch):
    """Each family's SMOKE config: with ``cfg.remat`` the training forward
    goes through one checkpoint a layer (whisper: encoder and decoder;
    zamba2: its Mamba layers, as the reference), and its loss and
    gradients equal the forward without, bit for bit (the recomputation
    repeats the same arithmetic); a forward over params without grad
    (serving) checkpoints nothing."""
    import repro_torch.models.model as mm

    calls = []
    monkeypatch.setattr(mm, "checkpoint", lambda *a, **k: calls.append(1) or
                        torch.utils.checkpoint.checkpoint(*a, **k))
    out = []
    for remat in (True, False):
        cfg = get_smoke(arch).replace(remat=remat)
        model = build_model(cfg, "cpu")
        params = model.init(0)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family in ("encdec", "vlm"):
            t, d = (cfg.encoder_ctx, cfg.d_model) if cfg.family == "encdec" else \
                (cfg.vision_tokens, cfg.vision_dim)
            batch["frontend"] = torch.from_numpy(rng.normal(size=(2, t, d)).astype(np.float32))
        model.forward(params, batch)                # params without grad, as serving has
        assert not calls
        leaves = [p.requires_grad_(True) for _, p in tree_flatten_with_names(params)]
        loss, _ = loss_fn(model, TrainConfig(), params, batch)
        out.append((loss, torch.autograd.grad(loss, leaves, allow_unused=True), len(calls)))
        calls.clear()
    (l1, g1, n1), (l0, g0, n0) = out
    layers = cfg.num_layers + (cfg.num_encoder_layers if cfg.family == "encdec" else 0)
    assert (n1, n0) == (layers, 0)
    assert torch.equal(l1, l0)
    for a, b in zip(g1, g0):
        assert (a is None and b is None) or torch.equal(a, b)


def test_trainer_save_restore_resumes(tmp_path):
    """Four steps straight against two, a checkpoint, a new Trainer
    restored from it and two more: the same params byte for byte, the same
    data step and the same losses."""
    from repro_torch.config import RunConfig
    from repro_torch.resilience.checkpoint import CheckpointManager
    from repro_torch.resilience.voting import ReplicaVoter
    from repro_torch.train.trainer import Trainer

    cfg = ModelConfig(**TINY_KW)
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    tcfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=8, slice_steps=2)

    def trainer(ckpt_dir):
        model = build_model(cfg, "cpu")
        return Trainer(RunConfig(model=cfg, shape=shape, train=tcfg),
                       make_train_step(model, tcfg), init_train_state(model, tcfg, 0),
                       data.pipeline_for(cfg, shape, seed=5),
                       ckpt=CheckpointManager(ckpt_dir), voter=ReplicaVoter(1),
                       put_batch=lambda b: {k: torch.from_numpy(v) for k, v in b.items()})

    straight = trainer(tmp_path / "a")
    losses = [straight.run_slice(2)["loss"], straight.run_slice(2)["loss"]]
    first = trainer(tmp_path / "b")
    assert first.run_slice(2)["loss"] == losses[0]
    first.save()
    resumed = trainer(tmp_path / "b")
    assert resumed.restore() and resumed.current_step() == 2
    assert resumed.pipeline.step == 2
    assert resumed.run_slice(2)["loss"] == losses[1]
    assert resumed.current_step() == straight.current_step() == 4
    a = tree_flatten_with_names(straight.state)
    b = dict(tree_flatten_with_names(resumed.state))
    for name, leaf in a:
        assert torch.equal(leaf.detach(), b[name].detach()), name
    assert straight.voter.fault_rate == 0.0 and len(straight.voter.history) == 2
    for t in (straight, first, resumed):
        t.pipeline.close()


def test_launch_train_cli(capsys, tmp_path):
    from repro_torch.launch.train import main

    assert main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "3", "--batch", "2",
                 "--seq", "16", "--slice-steps", "2", "--ckpt-dir", str(tmp_path)],
                device="cpu") == 0
    out = capsys.readouterr().out
    assert "done at step 3" in out and "step     2" in out and "on cpu" in out
    assert f"{get_smoke('h2o-danube-1.8b').param_count():,} params" in out


# -- parameter counts -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches(arch):
    """Exact, from the meta-device tree against the reference's eval_shape."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jparam_count(jcfg)
    assert cfg.active_param_count() == jactive_count(jcfg)


def test_shapes_and_configs_equal_reference():
    from repro.config import SHAPES as JSHAPES
    from repro.config import MeshConfig as JMeshConfig
    from repro.config.base import shape_runs_for as jshape_runs_for
    from repro_torch.config import SHAPES, MeshConfig, RunConfig, shape_runs_for

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    for mp in (False, True):
        m, jm = MeshConfig(multi_pod=mp), JMeshConfig(multi_pod=mp)
        assert (m.shape, m.axis_names, m.num_devices, m.dp_axes) == \
            (jm.shape, jm.axis_names, jm.num_devices, jm.dp_axes)
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_runs_for(get_arch(arch), SHAPES[name]) == \
                jshape_runs_for(jget_arch(arch), JSHAPES[name])
    run = RunConfig(model=get_smoke("h2o-danube-1.8b"), shape=SHAPES["train_4k"])
    assert run.replace(parallelism="dp").parallelism == "dp" and run.train == TrainConfig()


# -- flash attention's backward ---------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (1, 4, 4, 70, 70, 16, True, None),          # causal
    (2, 4, 2, 90, 90, 8, True, 20),             # window < S, GQA 2
    (1, 8, 2, 100, 100, 16, True, None),        # GQA 4
    (1, 4, 2, 50, 77, 16, False, None),         # non-causal, ragged Sk != Sq
])
def test_flash_bwd_ref_matches_jax_grad(B, H, KV, Sq, Sk, hd, causal, window):
    """``flash_attention_bwd_ref`` (from ``flash_attention_lse_ref``'s
    output and lse) against ``jax.grad`` of the reference's
    ``flash_attention_ref``, f32: dq, dk and dv within 1e-5 of the largest
    gradient value; the output within 1e-6."""
    rng = np.random.default_rng(Sq + hd)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    dout = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jflash_ref(q, k, v, causal=causal, window=window) * dout)

    jgrads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    out, lse = flash_attention_lse_ref(tq, tk, tv, causal=causal, window=window)
    jout = jflash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    assert _rel(_np(out), np.asarray(jout)) <= 1e-6
    grads = flash_attention_bwd_ref(tq, tk, tv, out, lse, torch.tensor(dout), causal=causal,
                                    window=window, q_block=32)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        assert _rel(_np(a), np.asarray(b)) <= 1e-5, name


def test_attention_grads_on_cpu_equal_plain_autograd():
    """On the CPU ``ops.attention`` is the plain version, so its output and
    gradients are autograd's through ``blocked_attention``, exactly; the
    ``FlashAttention`` function (the plain forward with lse and the plain
    backward on the CPU) gives them within 1e-5 relative."""
    rng = np.random.default_rng(9)
    base = [rng.normal(size=(2, 65, n, 16)).astype(np.float32) for n in (8, 2, 2)]
    dout = torch.tensor(rng.normal(size=(2, 65, 8, 16)).astype(np.float32))

    def grads(fn):
        leaves = [torch.tensor(x, requires_grad=True) for x in base]
        out = fn(*leaves)
        out.backward(dout)
        return [out.detach()] + [t.grad for t in leaves]

    plain = grads(lambda q, k, v: blocked_attention(q, k, v, causal=True, window=30))
    op = grads(lambda q, k, v: flash_op(q, k, v, causal=True, window=30))
    fn = grads(lambda q, k, v: FlashAttention.apply(q.movedim(1, 2), k.movedim(1, 2),
                                                    v.movedim(1, 2), True, 30).movedim(1, 2))
    for a, b, c in zip(plain, op, fn):
        assert torch.equal(a, b)
        assert _rel(_np(c), _np(a)) <= 1e-5


def test_timer_and_bench_match_the_reference():
    """``Timer``'s statistics and ``timed`` equal the reference's on the
    same laps; ``bench`` calls ``fn`` warmup + iters times and returns the
    best lap of a host-clock Timer."""
    from repro.utils import timing as jtiming

    from repro_torch.utils import timing

    laps = [0.25, 0.5, 0.125]
    t, jt = timing.Timer(laps=list(laps)), jtiming.Timer(laps=list(laps))
    assert (t.total, t.mean, t.best) == (jt.total, jt.mean, jt.best)
    empty = timing.Timer()
    assert (empty.total, empty.mean, empty.best) == (0, 0.0, 0.0)
    with timing.timed(t) as same:
        assert same is t
    assert len(t.laps) == 4 and t.laps[-1] >= 0.0
    with pytest.raises(AssertionError):
        timing.Timer().stop()
    calls = []
    best = timing.bench(lambda x: calls.append(x), 7, warmup=3, iters=4)
    assert calls == [7] * 7 and 0.0 <= best < 1.0
