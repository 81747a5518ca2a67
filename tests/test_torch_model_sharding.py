"""The port's model-side sharding against the JAX package on the CPU.

The spec functions are pure, and are held to the reference's directly:
every parameter leaf's partition spec for all ten archs (meta trees, the
port's per-layer leaves against the reference's stacked (L, ...) leaves
without the layer axis), on the production meshes and a small three-axis
one, with FSDP on and off, under the "tp_sp" and "dp" presets; the KV-cache
layout and the cache spec trees of every family; ``batch_pspec``;
``make_rules``' mapping; ``Model.input_specs``.  Then ``logical`` outside
a context, and one dry-run cell.

The reference's sharded steps do not run on the installed jax (its
``with_sharding_constraint`` refuses the Explicit-axis mesh
``jax.make_mesh`` builds), so the sharded steps are held, as the fleet's
mesh tests hold the fleet, against the unsharded reference and the port's
unsharded path: a gloo world of 4 CPU processes on the (data 2, model 2) mesh runs
the sharded prefill, two decode steps and two SGD train steps (FSDP on
every leaf of 1024 elements or more) of the h2o-danube-1.8b, rwkv6-7b and
qwen2-moe-a2.7b SMOKE configs in f32 from the reference's weights, then
on the (pod 2, data 1, model 2) mesh danube's, then decode steps over
caches that shard their sequence (granite's one KV head, batch-1 decode).
The all-reduces take the sums in another order, so the logits, caches
and losses are held at 1e-5 (absolute on values of order 1, relative on
the loss) and the parameters after two steps at 1e-5 of the largest, as
``tests/test_torch_train.py`` holds the unsharded steps.  The world runs
once for the file, in processes of its own, each with a time limit, and
destroys its group however it ends.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MeshConfig as JMeshConfig
from repro.config import SHAPES as JSHAPES
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.kernels import set_kernels
from repro.models import build_model as jbuild_model
from repro.models.quantized import quantize_params as jquantize_params
from repro.sharding import cache_specs as jcache_specs
from repro.sharding import rules as jrules
from repro.train import train_step as jts

from repro_torch.config import SHAPES, MeshConfig, RunConfig, ShapeConfig, TrainConfig, get_arch
from repro_torch.config import get_smoke, list_archs
from repro_torch.launch import dryrun, steps
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.counting import _MetaGenerator
from repro_torch.models.quantized import quantize_params
from repro_torch.roofline import report
from repro_torch.sharding import cache_specs, logical, logical_rules, make_fleet_rules, rules
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.utils.tree import tree_flatten_with_names

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
MESHES = {"16x16": dict(), "2x16x16": dict(multi_pod=True),
          "2x2x2": dict(multi_pod=True, pods=2, data=2, model=2)}


# -- parameter specs -------------------------------------------------------------------

_JSHAPES: dict = {}


def _jshapes(arch, quantized):
    if (arch, quantized) not in _JSHAPES:
        jm = jbuild_model(jget_arch(arch))
        init = (lambda k: jquantize_params(jm.init(k))) if quantized else jm.init
        _JSHAPES[arch, quantized] = jax.eval_shape(init, jax.random.key(0))
    return _JSHAPES[arch, quantized]


def _shapes(arch, quantized):
    p = build_model(get_arch(arch), "meta").init(_MetaGenerator())
    return quantize_params(p) if quantized else p


def _flat(tree, prefix=""):
    """(name, spec) pairs of a port spec tree (dicts and lists of tuples)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _reference_specs(arch, quantized, jmc, **kw):
    flat = jax.tree_util.tree_flatten_with_path(_jshapes(arch, quantized))[0]
    out = {}
    for path, x in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[name] = tuple(jrules.param_partition_spec(name, x.shape, jmc, **kw))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    """Every leaf, every mesh, FSDP on and off, tp_sp and dp, and the
    quantized serving tree: the port's spec is the reference's, the
    stacked layer axis dropped."""
    stacked = get_arch(arch).family != "hybrid"
    for quantized in (False, True):
        shapes = _shapes(arch, quantized)
        for mesh, kw in MESHES.items():
            mc, jmc = MeshConfig(**kw), JMeshConfig(**kw)
            for fsdp, preset in ((False, "tp_sp"), (True, "tp_sp"), (True, "dp"), (False, "dp")):
                if quantized and (fsdp or preset == "dp"):
                    continue
                ref = _reference_specs(arch, quantized, jmc, fsdp=fsdp, preset=preset)
                got = _flat(rules.param_pspec_tree(shapes, mc, fsdp=fsdp, preset=preset))
                seen = set()
                for name, spec in got:
                    parts = name.split("/")
                    if stacked and parts[0] in ("layers", "enc_layers"):
                        key = "/".join(parts[:1] + parts[2:])
                        want = ref[key][1:]
                    else:
                        key, want = name, ref[name]
                    assert spec == want, (mesh, fsdp, preset, name, spec, want)
                    seen.add(key)
                assert seen == set(ref), (mesh, set(ref) ^ seen)


# -- caches, batches, rules, inputs --------------------------------------------------------

def _spec_leaves(tree):
    """The spec leaves (tuples) of a cache spec tree of NamedTuples and
    lists, P or tuple leaves, in order."""
    if hasattr(tree, "_fields"):
        return [x for v in tree for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tuple(tree)]


CACHE_CELLS = [(128, 32768, False), (1, 524288, True), (8, 4096, False), (2, 1000, False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_and_specs_equal_reference(arch):
    for kv_dtype in ("auto", "int8"):
        cfg = get_arch(arch).replace(kv_cache_dtype=kv_dtype)
        jcfg = jget_arch(arch).replace(kv_cache_dtype=kv_dtype)
        for kw in MESHES.values():
            mc, jmc = MeshConfig(**kw), JMeshConfig(**kw)
            for B, L, seq_shard in CACHE_CELLS:
                assert cache_specs.kv_cache_layout(cfg, mc, B, L, seq_shard=seq_shard) == \
                    jcache_specs.kv_cache_layout(jcfg, jmc, B, L, seq_shard=seq_shard)
                got = cache_specs.cache_pspec(cfg, mc, B, L, seq_shard=seq_shard)
                want = jcache_specs.cache_pspec(jcfg, jmc, B, L, seq_shard=seq_shard)
                assert type(got).__name__ == type(want).__name__
                assert _spec_leaves(got) == _spec_leaves(want), (B, L, seq_shard)


def test_batch_pspec_and_rules_mapping_equal_reference():
    cfg = get_arch("glm4-9b")
    for kw in MESHES.values():
        mc, jmc = MeshConfig(**kw), JMeshConfig(**kw)
        for seq in (False, True):
            assert rules.batch_pspec(mc, seq_sharding=seq) == tuple(jrules.batch_pspec(jmc, seq_sharding=seq))
        layout = cache_specs.kv_cache_layout(cfg, mc, 1, 32768, seq_shard=True)
        for preset in ("tp_sp", "tp", "dp"):
            for seq, act, lay in ((False, False, None), (True, False, layout), (False, True, None)):
                got = rules.make_rules(None, mc, seq_sharding=seq, act_seq=act,
                                       kv_cache_layout=lay, preset=preset).mapping
                want = jrules.make_rules(None, jmc, seq_sharding=seq, act_seq=act,
                                         kv_cache_layout=lay, preset=preset).mapping
                assert got == want, (preset, seq, act)
    assert rules.DEFAULT_RULES is rules.make_rules


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    model, jmodel = build_model(get_arch(arch), "meta"), jbuild_model(jget_arch(arch))
    for name, shape in SHAPES.items():
        got, want = model.input_specs(shape), jmodel.input_specs(JSHAPES[name])
        assert list(got) == list(want)
        for k, x in got.items():
            assert x.device.type == "meta"
            assert tuple(x.shape) == tuple(want[k].shape)
            assert x.dtype == _DTYPES[str(want[k].dtype)]


def test_logical_is_a_no_op_without_model_rules():
    x = torch.ones(2, 3, 4)
    assert logical(x, "batch", "seq", "embed") is x
    from repro_torch.launch.mesh import make_node_mesh

    with logical_rules(make_fleet_rules(make_node_mesh(2, device="cpu"))):
        assert logical(x, "batch", "seq", "embed") is x


def test_dryrun_smoke_cell(monkeypatch):
    """One cell of the dry-run on the SMOKE danube config: the record's
    keys, memory from the specs (outputs = the state + five f32 metrics),
    the counted FLOPs, the analytic terms equal the reference's, and the
    report renders it."""
    monkeypatch.setattr(dryrun, "get_arch", get_smoke)
    rec = dryrun.run_cell("h2o-danube-1.8b", "train_4k", False, verbose=False)
    assert rec["status"] == "ok"
    assert set(rec) == {"arch", "shape", "mesh", "kind", "parallelism", "status", "count_s",
                        "memory", "cost", "analytic", "roofline"}
    m = rec["memory"]
    assert m["output_size_in_bytes"] == m["argument_size_in_bytes"] - 256 * 4096 * 4 * 2 // 16 + 20
    assert rec["cost"]["counted_by"] == "FlopCounterMode" and rec["cost"]["flops"] > 0
    jcfg = jget_smoke("h2o-danube-1.8b")
    from repro.roofline import analytic as janalytic

    stack, head = janalytic.forward_flops(jcfg, 256, 4096)
    assert rec["analytic"]["flops_global"] == 4 * stack + 3 * head
    assert rec["analytic"]["collective_per_chip"] == janalytic.collective_bytes(
        jcfg, JSHAPES["train_4k"], JMeshConfig())
    assert "(counted)" in report.dryrun_table([rec], "16x16")


# -- the sharded steps in a gloo world of 4 ------------------------------------------------

WORLD_ARCHS = ("h2o-danube-1.8b", "rwkv6-7b", "qwen2-moe-a2.7b")
B, S, C, DECODE_STEPS, TRAIN_STEPS = 4, 8, 8, 2, 2
TRAIN_KW = dict(lr=0.2, warmup_steps=2, total_steps=50, optimizer="sgd")
# (mesh, its configs): the three-axis mesh shares every code path but the
# dropped size-1 axis, so it runs danube alone.
WORLD_MESHES = {"2x2": (dict(data=2, model=2), WORLD_ARCHS),
                "2x1x2": (dict(multi_pod=True, pods=2, data=1, model=2), WORLD_ARCHS[:1])}
# Decode over a cache that shards its sequence, on the (data 2, model 2)
# mesh: (arch, batch, cache length, steps, config overrides, the cache's
# expected placements).  granite's one KV head does not divide "model", so
# its cache shards the sequence there (and at batch 1 over both axes);
# danube's batch-1 window cache shards it over "data" and wraps around.
# Each runs past a shard boundary.
SEQ_DECODE = {
    "granite-b4": ("granite-34b", 4, 4, 3, {}, "(Shard(dim=1), Shard(dim=2))"),
    "granite-int8-b1": ("granite-34b", 1, 8, 3, {"kv_cache_dtype": "int8"},
                        "(Shard(dim=2), Shard(dim=2))"),
    "danube-b1": ("h2o-danube-1.8b", 1, 4, 6, {}, "(Shard(dim=2), Shard(dim=3))"),
}

RANK = textwrap.dedent('''
    import os
    import sys
    import torch
    import torch.distributed as dist

    rank, world, port, inp, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    os.nice(10)     # the test run's other workers keep the CPU first
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        from repro_torch.sharding import rules
        from repro_torch.train.optimizer import make_optimizer
        from repro_torch.train.train_step import TrainState
        from repro_torch.utils.tree import tree_map

        rules.FSDP_MIN_SIZE = 1024      # FSDP shards the SMOKE leaves, far below 2**18
        data = torch.load(inp, weights_only=False)
        full = lambda t: tree_map(lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x, t)
        meshes, res = {}, {}
        for key, d in data["jobs"].items():
            mc = MeshConfig(**d["mesh"])
            if mc not in meshes:
                meshes[mc] = make_mesh(mc, "cpu")
            mesh = meshes[mc]
            cfg, params, tokens = d["cfg"], d["params"], d["tokens"]
            B, S = tokens.shape
            r = res[key] = {}
            if "prefill" in d["kinds"]:
                run = RunConfig(model=cfg, mesh=mc, shape=ShapeConfig("p", S, B, "prefill"))
                r["prefill"] = steps.build_prefill(run, mesh).fn(params, {"tokens": tokens}).full_tensor()
            run = RunConfig(model=cfg, mesh=mc, shape=ShapeConfig("d", d["cache"], B, "decode"))
            sf = steps.build_decode(run, mesh)
            cache = build_model(cfg, "cpu").init_cache(B, d["cache"])
            r["decode"] = []
            for i in range(d["decode_steps"]):
                logits, cache = sf.fn(params, cache, tokens[:, i:i + 1])
                r["decode"].append(logits.full_tensor())
            if hasattr(cache, "k"):
                r["cache_placements"] = str(tuple(cache.k.placements))
            r["cache"] = full(cache)
            if "train" in d["kinds"]:
                tc = TrainConfig(**data["train"])
                run = RunConfig(model=cfg, mesh=mc, train=tc, shape=ShapeConfig("t", S, B, "train"))
                sf = steps.build_train_step(run, mesh)
                init, _ = make_optimizer(tc)
                state = TrainState(params, init(params), torch.Generator().get_state(),
                                   torch.zeros((), dtype=torch.int32))
                r["loss"] = []
                for _ in range(d["train_steps"]):
                    state, m = sf.fn(state, {"tokens": tokens, "labels": d["labels"]})
                    r["loss"].append(float(m["loss"]))
                r["params"] = full(state.params)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_world(script, inp, out):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen([sys.executable, script, str(r), "4", str(port), inp, out],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(4)]


def _wait(procs, timeout):
    """Wait for every rank; kill them all on a timeout or a failure, so no
    process outlives the test."""
    try:
        outs = [p.communicate(timeout=timeout)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _np(t):
    return t.detach().float().numpy()


def _decode_both(jm, jparams, md, params, tokens, cache_len, steps_):
    """``steps_`` decode steps of the reference and the port from empty
    caches: (the reference's logits, the port's logits, the port's cache)."""
    Bd = tokens.shape[0]
    jc, jd = jm.init_cache(Bd, cache_len), jax.jit(jm.decode_step)
    c = md.init_cache(Bd, cache_len)
    jl_all, pl_all = [], []
    for i in range(steps_):
        jl, jc = jd(jparams, jc, jnp.asarray(tokens[:, i:i + 1]))
        pl, c = md.decode_step(params, c, torch.from_numpy(tokens[:, i:i + 1]))
        jl_all.append(np.asarray(jl))
        pl_all.append(_np(pl))
    return jl_all, pl_all, c


def _unsharded(arch):
    """The reference's and the port's unsharded results from the
    reference's weights: (inputs for the ranks, a function that computes
    (JAX results, port results), so that the world runs meanwhile)."""
    set_kernels("auto")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:].copy()
    out = {}
    for kind in ("prefill", "decode", "train"):
        shape = ShapeConfig(kind, C if kind == "decode" else S, B, kind)
        # both meshes have two data-parallel shards: MoE groups of 2
        run = RunConfig(model=get_smoke(arch), shape=shape, mesh=MeshConfig(data=2, model=2))
        cfg = steps.cell_run(run).model
        out[kind] = cfg
    cfg = out["train"]
    assert out["prefill"] == cfg and out["decode"].replace(moe_groups=cfg.moe_groups) == cfg
    jcfg = jget_smoke(arch).replace(moe_groups=cfg.moe_groups)
    jtc, tc = JTrainConfig(**TRAIN_KW), TrainConfig(**TRAIN_KW)
    jm = jbuild_model(jcfg)
    jstate = jts.init_train_state(jm, jtc, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jstate.params)
    params = lambda c: params_from_jax(np_params, c, "cpu")
    ranks = {"cfg": get_smoke(arch), "params": params(cfg), "tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels), "cache": C, "decode_steps": DECODE_STEPS,
             "train_steps": TRAIN_STEPS, "kinds": ("prefill", "decode", "train")}
    return ranks, lambda: _results(jm, jtc, jstate, jcfg, cfg, out["decode"], tc, params,
                                   tokens, labels)


def _results(jm, jtc, jstate, jcfg, cfg, dcfg, tc, params, tokens, labels):
    j, p = {}, {}
    j["prefill"] = np.asarray(jax.jit(lambda q, b: jm.forward(q, b)[0])(
        jstate.params, {"tokens": jnp.asarray(tokens)}))
    m = build_model(cfg, "cpu")
    p["prefill"] = _np(m.forward(params(cfg), {"tokens": torch.from_numpy(tokens)})[0])

    j["decode"], p["decode"], p["cache"] = _decode_both(
        jbuild_model(jcfg.replace(moe_groups=dcfg.moe_groups)), jstate.params,
        build_model(dcfg, "cpu"), params(dcfg), tokens, C, DECODE_STEPS)

    jstep, step = jax.jit(jts.make_train_step(jm, jtc)), make_train_step(m, tc)
    init, _ = make_optimizer(tc)
    tp = params(cfg)
    state = TrainState(tp, init(tp), torch.Generator().get_state(), torch.zeros((), dtype=torch.int32))
    j["loss"], p["loss"] = [], []
    batch = {"tokens": tokens, "labels": labels}
    for _ in range(TRAIN_STEPS):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        j["loss"].append(float(jmet["loss"]))
        p["loss"].append(float(met["loss"]))
    j["params"] = jax.tree.map(np.asarray, jstate.params)
    p["params"] = state.params
    return j, p


def _unsharded_decode(arch, Bd, cache_len, steps_, overrides):
    """Decode only, for the sequence-sharded caches: (inputs for the ranks,
    a function that computes (JAX results, port results))."""
    set_kernels("auto")
    tokens = np.random.default_rng(1).integers(0, 512, (Bd, steps_)).astype(np.int32)
    cfg, jcfg = get_smoke(arch).replace(**overrides), jget_smoke(arch).replace(**overrides)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    ranks = {"cfg": cfg, "params": params, "tokens": torch.from_numpy(tokens), "cache": cache_len,
             "decode_steps": steps_, "kinds": ("decode",)}

    def results():
        j, p = {}, {}
        j["decode"], p["decode"], p["cache"] = _decode_both(
            jm, jparams, build_model(cfg, "cpu"), params, tokens, cache_len, steps_)
        return j, p

    return ranks, results


def _close(a, b, atol=1e-5, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= atol, (what, np.abs(a - b).max())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One gloo world of 4 rank processes runs every case in turn, each
    rank with its own time limit; the group is destroyed in a
    ``finally``.  Returns ({case: (JAX results, port results)}, {case: the
    ranks' results})."""
    tmp = tmp_path_factory.mktemp("world")
    jobs, todo = {}, {}
    unsharded = {a: _unsharded(a) for a in WORLD_ARCHS}
    for mesh, (mesh_kw, archs) in WORLD_MESHES.items():
        for arch in archs:
            ranks, todo[mesh, arch] = unsharded[arch]
            jobs[mesh, arch] = ranks | {"mesh": mesh_kw}
    for case, (arch, Bd, L, n, over, _) in SEQ_DECODE.items():
        ranks, todo[case] = _unsharded_decode(arch, Bd, L, n, over)
        jobs[case] = ranks | {"mesh": WORLD_MESHES["2x2"][0]}
    inp, out = str(tmp / "inputs.pt"), str(tmp / "out.pt")
    torch.save({"jobs": jobs, "train": TRAIN_KW}, inp)
    script = str(tmp / "rank.py")
    with open(script, "w") as f:
        f.write(RANK)
    procs = _start_world(script, inp, out)
    try:                                    # the unsharded results while the world runs
        done = {}
        want = {k: done.setdefault(f, f()) for k, f in todo.items()}
    finally:
        rcs, outs = _wait(procs, timeout=600)
    assert rcs == [0] * 4, (rcs, outs[rcs.index(next(r for r in rcs if r))][-3000:])
    return want, torch.load(out, weights_only=False)


def _check_decode(r, j, p, what):
    for i in range(len(p["decode"])):
        _close(_np(r["decode"][i]), p["decode"][i], what=f"{what} decode {i} vs port")
        _close(_np(r["decode"][i]), j["decode"][i], what=f"{what} decode {i} vs jax")
    for (name, x), (_, y) in zip(tree_flatten_with_names(r["cache"]),
                                 tree_flatten_with_names(p["cache"])):
        if isinstance(x, torch.Tensor):
            _close(_np(x), _np(y), what=f"{what} cache {name}")
        else:
            assert x == y, (what, name)


@pytest.mark.parametrize("mesh", list(WORLD_MESHES))
def test_sharded_steps_in_a_gloo_world_of_four(mesh, world):
    """Prefill, decode and two train steps on ``mesh``, against the
    unsharded port and the unsharded reference."""
    want, res = world
    for arch in WORLD_MESHES[mesh][1]:
        j, p = want[mesh, arch]
        r = res[mesh, arch]
        what = f"{mesh} {arch}"
        _close(_np(r["prefill"]), p["prefill"], what=what + " prefill vs port")
        _close(_np(r["prefill"]), j["prefill"], what=what + " prefill vs jax")
        _check_decode(r, j, p, what)
        for i in range(TRAIN_STEPS):
            assert r["loss"][i] == pytest.approx(p["loss"][i], rel=1e-5), (what, i)
            assert r["loss"][i] == pytest.approx(j["loss"][i], rel=1e-5), (what, i)
        got = dict(tree_flatten_with_names(r["params"]))
        for name, y in tree_flatten_with_names(p["params"]):
            tol = 1e-5 * float(y.detach().abs().max())
            _close(_np(got[name]), _np(y), atol=max(tol, 1e-7), what=f"{what} param {name}")
        ref = dict(tree_flatten_with_names(params_to_jax(r["params"])))
        for path, leaf in jax.tree_util.tree_flatten_with_path(j["params"])[0]:
            key = "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)
            b = np.asarray(leaf)
            _close(ref[key], b, atol=max(1e-5 * np.abs(b).max(), 1e-7),
                   what=f"{what} param {key} vs jax")


@pytest.mark.parametrize("case", list(SEQ_DECODE))
def test_sequence_sharded_decode_in_a_gloo_world_of_four(case, world):
    """Decode steps over a cache whose sequence is sharded (the softmax
    combined across the shards), against the unsharded port and the
    unsharded reference at 1e-5; the cache lies as the case says."""
    want, res = world
    r = res[case]
    assert r["cache_placements"] == SEQ_DECODE[case][-1], r["cache_placements"]
    _check_decode(r, *want[case], what=case)
