"""Sharded steps: the bridge between the models and a mesh
(counterpart of ``repro.launch.steps``).

``build_train_step`` / ``build_prefill`` / ``build_decode`` return a
:class:`ShardedFn`: the step, the shapes of its arguments (meta tensors),
and the spec and placement trees of its arguments and results.  Its
``fn`` places every argument as DTensors by its specs over a
``DeviceMesh`` (each rank keeps its shard; an argument placed already is
left as it is), then runs the port's own ``make_train_step``,
``Model.forward`` or ``Model.decode_step`` under the cell's
``logical_rules``, where the model's ``logical()`` calls place the
activations and the kernels run on local shards
(``sharding.local``).  Plain tensors the model makes (positions, masks,
zero states) count as replicated (``implicit_replication``).

A leaf whose spec is ``None`` is a host value (a step counter, the RNG
state) and is never placed.  Built with ``mesh=None``, a ShardedFn has
shapes and specs only (the dry-run); its ``fn`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import MeshConfig, RunConfig
from repro_torch.models.counting import _MetaGenerator
from repro_torch.models.model import build_model
from repro_torch.models.quantized import quantize_params
from repro_torch.sharding.api import (
    axis_sizes,
    compute_mesh,
    distribute,
    fit_spec,
    logical_rules,
    placements,
)
from repro_torch.sharding.cache_specs import cache_pspec, kv_cache_layout
from repro_torch.sharding.rules import make_rules, param_pspec_tree
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step

METRICS = ("ce", "z_loss", "aux", "grad_norm", "lr", "loss")


@dataclass
class ShardedFn:
    fn: Callable                # the sharded step; places its arguments
    arg_specs: tuple            # the arguments' shapes: trees of meta tensors
    in_specs: tuple             # spec trees of the arguments (None: a host value)
    out_specs: Any
    in_shardings: tuple         # placement trees (DTensor placements per leaf)
    out_shardings: Any
    mesh: Any                   # the DeviceMesh, or None (shapes only)
    init: Callable              # seed -> the full non-batch arguments, unplaced

    def place(self, *args):
        """The arguments placed by ``in_specs`` (as ``fn`` places them)."""
        return tuple(_place(a, s, self.mesh) for a, s in zip(args, self.in_specs))


# -- trees ---------------------------------------------------------------------------

def zip_map(fn, values, specs):
    """``fn(value, spec)`` over a value tree (dicts, lists, tuples,
    NamedTuples) and its spec tree, whose leaves are tuples or None."""
    if isinstance(values, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in values.items()}
    if hasattr(values, "_fields"):
        return type(values)(*[zip_map(fn, v, s) for v, s in zip(values, specs)])
    if isinstance(values, (list, tuple)):
        return type(values)(zip_map(fn, v, s) for v, s in zip(values, specs))
    return fn(values, specs)


def _placement_tree(shapes, specs, names):
    return zip_map(lambda _x, s: None if s is None else placements(names, s), shapes, specs)


def _place(values, specs, mesh):
    def one(x, spec):
        if spec is None or not isinstance(x, torch.Tensor):
            return x
        spec = fit_spec(x.shape, spec, axis_sizes(mesh))
        want = placements(mesh.mesh_dim_names, spec)
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == want else x.redistribute(mesh, want)
        return distribute(x, mesh, spec)

    if mesh is None:
        raise RuntimeError("this ShardedFn was built without a mesh (shapes only)")
    mesh = compute_mesh(mesh)
    return zip_map(one, values, specs)


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _device(mesh):
    if mesh is None:
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dp(mesh_cfg: MeshConfig):
    dp = mesh_cfg.dp_axes
    return (dp if len(dp) > 1 else dp[0]), mesh_cfg.data * (mesh_cfg.pods if mesh_cfg.multi_pod else 1)


def _batch_specs(mesh_cfg: MeshConfig, batch_shapes, preset: str = "tp_sp"):
    """Each batch leaf's leading (batch) dim on the data-parallel axes
    (every axis under "dp") when they divide it."""
    if preset == "dp":
        axes, size = tuple(mesh_cfg.axis_names), int(np.prod(mesh_cfg.shape))
        axes = axes if len(axes) > 1 else axes[0]
    else:
        axes, size = _dp(mesh_cfg)

    def spec(x):
        B = x.shape[0]
        return (axes if (B % size == 0 and B > 1) else None,) + (None,) * (x.ndim - 1)

    return {k: spec(x) for k, x in batch_shapes.items()}


def _logits_spec(run: RunConfig, B: int, decode: bool) -> tuple:
    mesh_cfg = run.mesh
    dp, dp_size = _dp(mesh_cfg)
    ok = B % dp_size == 0 and (B > 1 or not decode)
    return (dp if ok else None, None,
            "model" if run.model.padded_vocab % mesh_cfg.model == 0 else None)


def _meta_model(cfg):
    return build_model(cfg, "meta")


# ---------------------------------------------------------------------------


def _with_moe_groups(run: RunConfig) -> RunConfig:
    """MoE grouped dispatch: one group per DP shard (the token permutation
    stays sharded; see models/moe.py)."""
    cfg = run.model
    if cfg.family != "moe" or cfg.moe_groups != 1:
        return run
    mesh_cfg = run.mesh
    if run.parallelism == "dp":
        g = int(np.prod(mesh_cfg.shape))
    else:
        g = mesh_cfg.data * (mesh_cfg.pods if mesh_cfg.multi_pod else 1)
    tokens = run.shape.global_batch * run.shape.seq_len
    if tokens % g == 0:
        run = run.replace(model=cfg.replace(moe_groups=g))
    return run


def _decode_cfg(run: RunConfig):
    """Long-context hybrid: the shared attention block takes a sliding
    window at long_500k."""
    cfg = run.model
    if run.shape.name == "long_500k" and cfg.family == "hybrid" and cfg.sliding_window is None:
        cfg = cfg.replace(sliding_window=run.serve.long_window)
    return cfg


def cell_run(run: RunConfig) -> RunConfig:
    """The run a cell's step is built for (MoE groups for a train or
    prefill step, the long_500k window for a decode step)."""
    if run.shape.kind == "decode":
        return run.replace(model=_decode_cfg(run))
    return _with_moe_groups(run)


def _opt_pspec_tree(opt: OptState, param_specs) -> OptState:
    """Optimizer moments inherit the parameter specs; the scalar
    placeholders (lion/sgd) and the step are host values."""
    def match(m):
        return param_specs if isinstance(m, dict) else None

    return OptState(step=None, m=match(opt.m), v=match(opt.v))


class _Gathered:
    """A model whose forward first gathers each parameter's FSDP shards
    (its placement without "fsdp": ZeRO-3's all-gather before the
    compute, whose backward reduce-scatters the gradient onto the shard)."""

    def __init__(self, model, specs, mesh):
        self.model, self.cfg, self.specs, self.mesh = model, model.cfg, specs, mesh

    def forward(self, params, batch, **kw):
        return self.model.forward(_place(params, self.specs, self.mesh), batch, **kw)


def build_train_step(run: RunConfig, mesh, *, fsdp: bool = True) -> ShardedFn:
    """Sharded train step: FSDP+TP params and optimizer moments, DP batch,
    sequence-parallel activations between the layers (``act_seq``)."""
    run = _with_moe_groups(run)
    mesh_cfg = run.mesh
    model = build_model(run.model, _device(mesh))
    rules = None if mesh is None else make_rules(compute_mesh(mesh), mesh_cfg, act_seq=True,
                                                 preset=run.parallelism)

    state_shapes = init_train_state(_meta_model(run.model), run.train, _MetaGenerator())
    pspecs = param_pspec_tree(state_shapes.params, mesh_cfg, fsdp=fsdp, preset=run.parallelism)
    compute = param_pspec_tree(state_shapes.params, mesh_cfg, fsdp=False, preset=run.parallelism)
    train_step = make_train_step(model if mesh is None else _Gathered(model, compute, mesh),
                                 run.train)
    state_specs = TrainState(params=pspecs, opt=_opt_pspec_tree(state_shapes.opt, pspecs),
                             rng=None, step=None)
    batch_shapes = model.input_specs(run.shape)
    batch_specs = _batch_specs(mesh_cfg, batch_shapes, run.parallelism)
    metric_specs = {k: () for k in METRICS}
    names = mesh_cfg.axis_names

    def fn(state, batch):
        state, batch = _place(state, state_specs, mesh), _place(batch, batch_specs, mesh)
        with logical_rules(rules), implicit_replication():
            state, metrics = train_step(state, batch)
        return state, {k: _full(v) for k, v in metrics.items()}

    in_specs = (state_specs, batch_specs)
    out_specs = (state_specs, metric_specs)
    return ShardedFn(
        fn=fn,
        arg_specs=(state_shapes, batch_shapes),
        in_specs=in_specs,
        out_specs=out_specs,
        in_shardings=(_placement_tree(state_shapes, state_specs, names),
                      _placement_tree(batch_shapes, batch_specs, names)),
        out_shardings=(_placement_tree(state_shapes, state_specs, names),
                       {k: placements(names, ()) for k in METRICS}),
        mesh=mesh,
        init=lambda seed=0: (init_train_state(model, run.train, seed),),
    )


# ---------------------------------------------------------------------------


def build_prefill(run: RunConfig, mesh) -> ShardedFn:
    """Sharded full-sequence forward (inference prefill): TP params, DP
    batch."""
    run = _with_moe_groups(run)
    mesh_cfg = run.mesh
    model = build_model(run.model, _device(mesh))
    rules = None if mesh is None else make_rules(compute_mesh(mesh), mesh_cfg, act_seq=True)
    meta = _meta_model(run.model)

    param_shapes = meta.init(_MetaGenerator())
    pspecs = param_pspec_tree(param_shapes, mesh_cfg, fsdp=False)
    batch_shapes = meta.input_specs(run.shape)
    batch_specs = _batch_specs(mesh_cfg, batch_shapes)
    out_spec = _logits_spec(run, run.shape.global_batch, decode=False)
    names = mesh_cfg.axis_names

    def fn(params, batch):
        params, batch = _place(params, pspecs, mesh), _place(batch, batch_specs, mesh)
        with logical_rules(rules), implicit_replication():
            logits, _ = model.forward(params, batch)
        return _place(logits, out_spec, mesh)

    return ShardedFn(
        fn=fn,
        arg_specs=(param_shapes, batch_shapes),
        in_specs=(pspecs, batch_specs),
        out_specs=out_spec,
        in_shardings=(_placement_tree(param_shapes, pspecs, names),
                      _placement_tree(batch_shapes, batch_specs, names)),
        out_shardings=placements(names, out_spec),
        mesh=mesh,
        init=lambda seed=0: (model.init(seed),),
    )


def build_decode(run: RunConfig, mesh) -> ShardedFn:
    """Sharded single-token decode against a full cache: TP params, the
    cache by ``cache_pspec`` (its sequence sharded at batch 1,
    ``seq_shard``), int8 weights under ``quantized_serve``."""
    run = cell_run(run)
    model_cfg, shape, mesh_cfg = run.model, run.shape, run.mesh
    model = build_model(model_cfg, _device(mesh))
    meta = _meta_model(model_cfg)
    seq_shard = shape.global_batch == 1
    B, S = shape.global_batch, shape.seq_len

    cache_len = S if model_cfg.sliding_window is None else min(S, model_cfg.sliding_window)
    layout = kv_cache_layout(model_cfg, mesh_cfg, B, cache_len, seq_shard=seq_shard)
    rules = None if mesh is None else make_rules(compute_mesh(mesh), mesh_cfg,
                                                 seq_sharding=seq_shard, kv_cache_layout=layout)

    def init_params(m, seed):
        p = m.init(seed)
        # Paper-C4 serving: int8 weights + per-channel scale vectors.
        return quantize_params(p) if model_cfg.quantized_serve else p

    param_shapes = init_params(meta, _MetaGenerator())
    pspecs = param_pspec_tree(param_shapes, mesh_cfg, fsdp=False)
    cache_shapes = meta.init_cache(B, S)
    cache_specs = cache_pspec(model_cfg, mesh_cfg, B, S, seq_shard=seq_shard)
    tok_shape = torch.empty((B, 1), dtype=torch.int32, device="meta")
    dp, dp_size = _dp(mesh_cfg)
    tok_spec = (dp if B % dp_size == 0 and B > 1 else None, None)
    logits_spec = _logits_spec(run, B, decode=True)
    names = mesh_cfg.axis_names

    def fn(params, cache, tokens):
        params = _place(params, pspecs, mesh)
        cache = _place(cache, cache_specs, mesh)
        tokens = _place(tokens, tok_spec, mesh)
        with logical_rules(rules), implicit_replication():
            logits, cache = model.decode_step(params, cache, tokens)
        return _place(logits, logits_spec, mesh), _place(cache, cache_specs, mesh)

    cache_pl = _placement_tree(cache_shapes, cache_specs, names)
    return ShardedFn(
        fn=fn,
        arg_specs=(param_shapes, cache_shapes, tok_shape),
        in_specs=(pspecs, cache_specs, tok_spec),
        out_specs=(logits_spec, cache_specs),
        in_shardings=(_placement_tree(param_shapes, pspecs, names), cache_pl,
                      placements(names, tok_spec)),
        out_shardings=(placements(names, logits_spec), cache_pl),
        mesh=mesh,
        init=lambda seed=0: (init_params(model, seed), model.init_cache(B, S)),
    )


def build_for_shape(run: RunConfig, mesh) -> ShardedFn:
    """Dispatch on the shape kind (train/prefill/decode)."""
    if run.shape.kind == "train":
        return build_train_step(run, mesh)
    if run.shape.kind == "prefill":
        return build_prefill(run, mesh)
    return build_decode(run, mesh)
