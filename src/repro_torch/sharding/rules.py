"""Sharding rules (counterpart of ``repro.sharding.rules``): logical axes
-> mesh axes, and name-based parameter partition specs (DP / FSDP / TP /
EP / SP).  A spec is a tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of mesh axes.

Activation rules (used by ``logical()`` in the model code):
  batch    -> (pod, data)      data parallelism (hierarchical across pods)
  seq      -> data for batch=1 long-context decode (sequence parallelism)
  embed    -> None (replicated activations within a shard)
  ff/heads/kv_heads/expert/vocab -> model (tensor/expert parallelism)

Parameter rules match regexes against the reference's leaf names; the
port keeps a layer stack as a list (``layers/3/attn/wq``) where the
reference stacks it on a leading axis (``layers/attn/wq`` of shape
(L, ...)), so ``param_pspec_tree`` decides each per-layer leaf on the
stacked name and shape and drops the layer axis: every leaf gets the spec
of its reference counterpart.  ``fsdp`` additionally shards the largest
replicated dim over "data" (ZeRO-3 style).
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.config import MeshConfig
from repro_torch.sharding.api import LogicalRules


def make_rules(
    mesh,
    mesh_cfg: MeshConfig,
    *,
    seq_sharding: bool = False,
    act_seq: bool = False,
    kv_cache_layout: dict | None = None,
    preset: str = "tp_sp",
) -> LogicalRules:
    dp = tuple(mesh_cfg.dp_axes)
    if preset == "dp":
        # Pure (FS)DP: every mesh axis carries batch; no tensor parallelism.
        mapping = {
            "batch": tuple(mesh_cfg.axis_names),
            "seq": None,
            "act_seq": None,
            "embed": None, "ff": None, "heads": None, "kv_heads": None,
            "expert": None, "vocab": None,
            "cache_batch": None, "kv_seq": None, "cache_kv": None,
        }
        if kv_cache_layout:
            mapping.update(kv_cache_layout)
        return LogicalRules(mesh=mesh, mapping=mapping)
    mapping = {
        "batch": dp if len(dp) > 1 else dp[0],
        "seq": "data" if seq_sharding else None,
        # Megatron-style sequence parallelism: the residual stream shards
        # its seq dim over "model" between the layers' blocks.  Off under
        # the "tp" preset.
        "act_seq": "model" if (act_seq and preset == "tp_sp") else None,
        "embed": None,
        "ff": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
        "vocab": "model",
        # decode cache axes: bound per cell by build_decode
        "cache_batch": None,
        "kv_seq": None,
        "cache_kv": None,
    }
    if kv_cache_layout:
        mapping.update(kv_cache_layout)
    return LogicalRules(mesh=mesh, mapping=mapping)


DEFAULT_RULES = make_rules


def make_fleet_rules(mesh, node_axis: str = "node") -> LogicalRules:
    """Rules for the VM fleet: the logical ``"node"`` axis (the leading
    axis of a stacked ``VMState``) binds to the mesh's node axis, and
    everything else stays node-local.  ``logical_leading``'s divisibility
    rule makes a fleet the mesh does not divide replicate, so the same
    engines serve one shard and many."""
    if node_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {node_axis!r} axis")
    return LogicalRules(mesh=mesh, mapping={"node": node_axis})


# ---------------------------------------------------------------------------
# Parameter partition specs (name-based)
# ---------------------------------------------------------------------------

# (regex, trailing spec) — first match wins.  Specs are written for the
# *trailing* dims; ``_base_spec`` pads leading axes with None.
_RULES: list[tuple[str, tuple]] = [
    # embeddings / unembedding: vocab on model
    (r"embed/tokens$", ("vocab@model", "embed")),
    (r"lm_head$", ("embed", "vocab@model")),
    # attention projections: head dim on model
    (r"attn/wq$", ("embed", "heads@model")),
    (r"attn/wk$", ("embed", "kv@model")),
    (r"attn/wv$", ("embed", "kv@model")),
    (r"attn/wo$", ("heads@model", "embed")),
    (r"xattn/w[qkvo]$", ("embed", "heads@model")),
    # MoE: experts on model (EP)
    (r"moe/router$", ("embed", None)),
    (r"moe/w[13]$", ("expert@model", "embed", None)),
    (r"moe/w2$", ("expert@model", None, "embed")),
    (r"moe/shared/w[13]$", ("embed", "ff@model")),
    (r"moe/shared/w2$", ("ff@model", "embed")),
    # dense MLP: ff on model (megatron col->row)
    (r"(mlp|chan)/w[13k]$", ("embed", "ff@model")),
    (r"(mlp|chan)/w[2v]$", ("ff@model", "embed")),
    (r"chan/wr$", ("embed", "ff@model")),
    # rwkv6 time-mix square projections: output dim on model
    (r"time/w[rkvg]$", ("embed", "heads@model")),
    (r"time/wo$", ("heads@model", "embed")),
    (r"time/wa$", ("embed", None)),
    (r"time/wb$", (None, "embed")),
    # mamba2 (separate projections; z/x shard the inner dim, B/C/dt small)
    (r"mamba/w[zx]$", ("embed", "ff@model")),
    (r"mamba/out_proj$", ("ff@model", "embed")),
    # zamba2 shared block
    (r"shared/proj_in$", ("embed", None)),
    (r"vision_proj/w[12]$", ("embed", None)),
]


def _base_spec(name: str, ndim: int) -> list:
    # Quantized leaves: ".../wq/q" shards like ".../wq"; the 1-D scale
    # vector ".../wq/s" shards like the base weight's output dim.
    if name.endswith("/q"):
        name = name[:-2]
    elif name.endswith("/s"):
        base = _base_spec(name[:-2], 2)
        return [None] * (ndim - 1) + [base[-1]]
    for pat, trailing in _RULES:
        if re.search(pat, name):
            spec = [None] * ndim
            for k, ax in enumerate(reversed(trailing)):
                if ax is None or "@" not in str(ax):
                    continue
                spec[ndim - 1 - k] = ax.split("@")[1]
            return spec
    return [None] * ndim


def param_partition_spec(
    name: str,
    shape: tuple,
    mesh_cfg: MeshConfig,
    *,
    fsdp: bool = False,
    fsdp_min_size: int = 2**18,
    preset: str = "tp_sp",
) -> tuple:
    """Partition spec for one parameter under its reference name and
    shape."""
    ndim = len(shape)
    if preset == "dp":
        # Pure FSDP: shard the largest dim over as many axes as divide it.
        spec = [None] * ndim
        if int(np.prod(shape)) >= fsdp_min_size:
            axis_pools = [
                tuple(mesh_cfg.axis_names),          # all axes
                ("data", "model"),
                ("data",),
                ("model",),
            ]
            sizes = {"pod": mesh_cfg.pods, "data": mesh_cfg.data, "model": mesh_cfg.model}
            order = sorted(range(ndim), key=lambda i: -shape[i])
            for pool in axis_pools:
                n = int(np.prod([sizes[a] for a in pool]))
                for i in order:
                    if shape[i] % n == 0:
                        spec[i] = pool if len(pool) > 1 else pool[0]
                        return tuple(spec)
        return tuple(spec)
    spec = _base_spec(name, ndim)
    # Never shard dims not divisible by the mesh axis.
    for i, ax in enumerate(spec):
        if ax == "model" and shape[i] % mesh_cfg.model != 0:
            spec[i] = None
    if fsdp and int(np.prod(shape)) >= fsdp_min_size:
        # Shard the largest still-unsharded dim over "data" (ZeRO-3).
        cand = [
            (shape[i], i) for i in range(ndim)
            if spec[i] is None and shape[i] % mesh_cfg.data == 0
        ]
        if cand:
            _, i = max(cand)
            spec[i] = "data"
    return tuple(spec)


_STACKS = ("layers", "enc_layers")
# The smallest leaf (in elements) that ``param_pspec_tree`` lets FSDP or
# the "dp" preset shard: ``param_partition_spec``'s default.
FSDP_MIN_SIZE = 2**18


def _stacked(key: str, sub) -> bool:
    """The reference stacks this list of layers on a leading axis (the
    hybrid family's ``layers``, each holding a ``mamba`` block, it keeps a
    list)."""
    return key in _STACKS and isinstance(sub, list) and bool(sub) and "mamba" not in sub[0]


def param_pspec_tree(params, mesh_cfg: MeshConfig, *, fsdp: bool = False,
                     preset: str = "tp_sp"):
    """A tree of specs matching the port's parameter tree (tensors, meta
    tensors, or anything with ``.shape``).  A leaf of a stacked layer list
    takes the spec of its reference counterpart, the (L, ...) leaf,
    without the layer axis; that axis is never sharded."""
    from repro_torch.utils.tree import tree_map_with_names

    def spec(name, x, depth=None):
        shape = tuple(x.shape)
        kw = dict(fsdp=fsdp, preset=preset, fsdp_min_size=FSDP_MIN_SIZE)
        if depth is None:
            return param_partition_spec(name, shape, mesh_cfg, **kw)
        full = param_partition_spec(name, (depth,) + shape, mesh_cfg, **kw)
        if full[0] is not None:
            raise ValueError(f"{name}: the reference shards its layer axis ({full})")
        return full[1:]

    out = {}
    for key, sub in params.items():
        if _stacked(key, sub):
            out[key] = [tree_map_with_names(
                lambda n, x: spec(f"{key}/{n}", x, len(sub)), lp) for lp in sub]
        else:
            out[key] = tree_map_with_names(lambda n, x: spec(n, x), sub, key)
    return out


def batch_pspec(mesh_cfg: MeshConfig, *, seq_sharding: bool = False) -> tuple:
    """Spec for (B, S, ...) token batches."""
    dp = mesh_cfg.dp_axes
    b = dp if len(dp) > 1 else dp[0]
    if seq_sharding:
        # batch=1 long-context: shard the sequence dim instead.
        return (None, "data")
    return (b, None)
