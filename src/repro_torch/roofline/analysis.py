"""Roofline terms of a dry-run cell (counterpart of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh) cell, in seconds:

    compute    = global_FLOPs      / (chips * peak bf16 FLOP/s)
    memory     = global_HBM_bytes  / (chips * HBM bytes/s)
    collective = per-chip collective bytes / link bytes/s

``HW`` holds an NVIDIA H100 SXM's datasheet peaks in place of the TPU's.
The reference also parses collective bytes out of XLA's partitioned HLO
(``collective_bytes_from_hlo``, ``collective_bytes_scaled``); the port has
no HLO, so those two are not ported and the dry-run takes its collectives
from ``analytic.collective_bytes``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import MeshConfig, ModelConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM peaks from its datasheet, none of them measured:
    dense bf16 tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4 bytes/s each
    way (``ici_bw`` keeps the reference's field name for the link)."""

    peak_flops: float = 989e12      # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12         # B/s per card
    ici_bw: float = 450e9           # B/s per card, NVLink, each way


def summarize_cost(cost) -> dict:
    """Normalize a cost record (a dict, or a list of dicts, in the keys of
    XLA's ``cost_analysis()``: ``flops``, ``bytes accessed``, ...)."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    keys = {
        "flops": "flops",
        "bytes accessed": "bytes",
        "transcendentals": "transcendentals",
        "optimal_seconds": "optimal_seconds",
    }
    out = {}
    for k, name in keys.items():
        if k in cost:
            out[name] = float(cost[k])
    out["bytes_detail"] = {
        k: float(v) for k, v in cost.items() if k.startswith("bytes accessed")
    }
    return out


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward-only), N = active
    non-embedding params (MoE: top-k routed + shared)."""
    from repro_torch.models.counting import active_param_count, embedding_param_count

    n = active_param_count(cfg) - embedding_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one new token per sequence
    return 2.0 * n * shape.global_batch


def roofline_terms_from(
    flops_global: float,
    bytes_global: float,
    coll_per_chip: float,
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh_cfg: MeshConfig,
    hw: HW = HW(),
) -> dict:
    chips = mesh_cfg.num_devices
    compute_s = flops_global / chips / hw.peak_flops
    memory_s = bytes_global / chips / hw.hbm_bw
    collective_s = coll_per_chip / hw.ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / flops_global if flops_global else 0.0
    # Roofline fraction: time for the useful model flops at peak vs the
    # dominant term.
    dominant_s = terms[bottleneck]
    frac = (mf / chips / hw.peak_flops) / dominant_s if dominant_s > 0 else 0.0
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "bottleneck": bottleneck,
        "model_flops": mf,
        "flops_global": flops_global,
        "useful_flops_ratio": float(f"{useful:.4g}"),
        "roofline_fraction": float(f"{frac:.4g}"),
    }


def roofline_terms(
    cost: dict,
    coll: dict,
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh_cfg: MeshConfig,
    hw: HW = HW(),
) -> dict:
    """Terms from a per-chip cost record (``cost["flops"]``,
    ``cost["bytes"]``) and per-chip collective bytes by kind."""
    chips = mesh_cfg.num_devices
    return roofline_terms_from(
        cost.get("flops", 0.0) * chips,
        cost.get("bytes", 0.0) * chips,
        float(sum(coll.values())),
        cfg, shape, mesh_cfg, hw,
    )
