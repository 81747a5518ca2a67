"""Partition specs for decode caches, per model family (counterpart of
``repro.sharding.cache_specs``), over the port's ``KVCache``,
``RWKVState``, ``ZambaCache`` and ``WhisperCache``.

Conventions:
  * batch dim -> the data-parallel axes when divisible;
  * KV-head / head dims -> "model" when divisible (glm4 kv=2, granite kv=1
    fall back to replication — the cache shards its sequence instead);
  * for batch=1 long-context decode the *sequence* dim of the cache shards
    over the DP axes (sequence parallelism).

A ``KVCache.pos`` is a Python int in the port, which nothing places; its
spec is the reference's all the same.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.model import WhisperCache, ZambaCache
from repro_torch.models.rwkv6 import RWKVState


def _axes_size(mesh_cfg: MeshConfig, axes) -> int:
    sizes = {"pod": mesh_cfg.pods, "data": mesh_cfg.data, "model": mesh_cfg.model}
    if isinstance(axes, str):
        return sizes[axes]
    return int(np.prod([sizes[a] for a in axes]))


def _maybe(mesh_cfg, dim, axes):
    if axes is None:
        return None
    return axes if dim % _axes_size(mesh_cfg, axes) == 0 else None


def kv_cache_layout(
    cfg: ModelConfig,
    mesh_cfg: MeshConfig,
    batch: int,
    length: int,
    *,
    seq_shard: bool = False,
) -> dict:
    """Axis assignment for KV caches, shared by ``cache_pspec`` and the
    in-model ``logical()`` calls (through ``make_rules``):
      batch -> DP axes when divisible;
      kv_heads -> "model" when divisible;
      otherwise the cache *sequence* takes "model" (plus the DP axes for
      batch=1 long-context decode)."""
    dp = mesh_cfg.dp_axes
    dp_t = dp if len(dp) > 1 else dp[0]
    b_ax = _maybe(mesh_cfg, batch, dp_t) if batch > 1 else None
    kv_ax = _maybe(mesh_cfg, cfg.num_kv_heads, "model")
    seq_axes: list = []
    if seq_shard and batch == 1:
        seq_axes += list(dp)
    if kv_ax is None:
        seq_axes.append("model")
    s_ax = None
    while seq_axes:
        cand = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
        if length % _axes_size(mesh_cfg, cand) == 0:
            s_ax = cand
            break
        seq_axes.pop()  # drop the innermost axis and retry
    return {"cache_batch": b_ax, "kv_seq": s_ax, "cache_kv": kv_ax}


def cache_pspec(
    cfg: ModelConfig,
    mesh_cfg: MeshConfig,
    batch: int,
    cache_len: int,
    *,
    seq_shard: bool = False,
):
    """Spec tree matching ``model.init_cache(batch, cache_len)``."""
    dp = mesh_cfg.dp_axes
    dp = dp if len(dp) > 1 else dp[0]
    b_ax = _maybe(mesh_cfg, batch, dp) if batch > 1 else None

    def kv_spec(stacked: bool, length: int):
        lay = kv_cache_layout(cfg, mesh_cfg, batch, length, seq_shard=seq_shard)
        lead = (None,) if stacked else ()
        payload = (*lead, lay["cache_batch"], lay["kv_seq"], lay["cache_kv"], None)
        # Scale tensors exist only for the int8 cache; the float placeholder
        # is (1,1,1,1) and stays replicated.
        if cfg.kv_cache_dtype == "int8":
            scales = payload
        else:
            scales = (*lead, None, None, None, None)
        return KVCache(k=payload, v=payload, ks=scales, vs=scales, pos=lead)

    if cfg.family in ("dense", "moe", "vlm"):
        length = cache_len if cfg.sliding_window is None else min(cache_len, cfg.sliding_window)
        return kv_spec(stacked=True, length=length)

    if cfg.family == "rwkv6":
        K = cfg.ssm_head_dim
        H = cfg.d_model // K
        h_ax = _maybe(mesh_cfg, H, "model")
        return RWKVState(
            wkv=(None, b_ax, h_ax, None, None),
            shift_t=(None, b_ax, None),
            shift_c=(None, b_ax, None),
        )

    if cfg.family == "hybrid":
        from repro_torch.models.mamba2 import dims as m2dims

        inner, nheads = m2dims(cfg)
        conv_ch = inner + 2 * cfg.ssm_state
        h_ax = _maybe(mesh_cfg, nheads, "model")
        c_ax = _maybe(mesh_cfg, conv_ch, "model")
        every = cfg.attn_every or 6
        n_apps = cfg.num_layers // every
        window = cfg.sliding_window or cache_len
        attn_len = min(cache_len, window)
        mamba = [
            MambaState(ssd=(b_ax, h_ax, None, None), conv=(b_ax, None, c_ax))
            for _ in range(cfg.num_layers)
        ]
        attn = [kv_spec(stacked=False, length=attn_len) for _ in range(n_apps)]
        return ZambaCache(mamba=mamba, attn=attn)

    if cfg.family == "encdec":
        kv_ax = _maybe(mesh_cfg, cfg.num_kv_heads, "model")
        return WhisperCache(
            self_kv=kv_spec(stacked=True, length=cache_len),
            cross_k=(None, b_ax, None, kv_ax, None),
            cross_v=(None, b_ax, None, kv_ax, None),
        )

    raise ValueError(cfg.family)
