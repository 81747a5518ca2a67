"""Analytic FLOP / HBM-byte / collective-byte model, the roofline's
source (counterpart of ``repro.roofline.analytic``, equal to it float for
float).

It models the implementations as written: the dry-run's FLOPs counted by
``torch.utils.flop_counter.FlopCounterMode`` over the port's step are kept
beside it as a cross-check column, and the model is held within a band of
that count on small one-layer configs (``tests/test_torch_roofline.py``).

Conventions:
  * FLOPs/bytes are GLOBAL per optimizer step (train) or per call
    (prefill/decode); collectives are per-chip bytes on the busiest link.
  * Matmul = 2*m*n*k FLOPs.  Attention counts full S x S_k score blocks
    (causal masking does not skip blocks).
  * Train multiplies layer-stack forward cost by 4 (fwd + remat re-fwd +
    2x bwd) and non-rematted parts (unembed/loss) by 3.
  * HBM model: weight traffic (4x train / 1x inference), optimizer update
    (22 B/param), remat stash (2x L*tokens*D*2B), attention KV streaming,
    logits materialization, decode cache sweep.
"""

from __future__ import annotations

from repro_torch.config import MeshConfig, ModelConfig, ShapeConfig


def _dense_layer_fwd_flops(cfg: ModelConfig, B: int, S: int, S_k: int | None = None) -> float:
    """One dense transformer layer, forward."""
    N_t = B * S
    qd, kvd, D = cfg.q_dim, cfg.kv_dim, cfg.d_model
    S_k = S if S_k is None else S_k
    proj = 2 * N_t * D * (2 * qd + 2 * kvd)
    scores = 2 * B * cfg.num_heads * S * S_k * cfg.head_dim * 2
    mlp = (6 if cfg.mlp_gated else 4) * N_t * D * cfg.d_ff
    return proj + scores + mlp


def _moe_layer_fwd_flops(cfg: ModelConfig, B: int, S: int) -> float:
    N_t = B * S
    qd, kvd, D = cfg.q_dim, cfg.kv_dim, cfg.d_model
    proj = 2 * N_t * D * (2 * qd + 2 * kvd)
    scores = 2 * B * cfg.num_heads * S * S * cfg.head_dim * 2
    router = 2 * N_t * D * cfg.num_experts
    C = int((N_t * cfg.num_experts_per_tok * cfg.moe_capacity_factor
             + cfg.num_experts - 1) // cfg.num_experts)
    slots = cfg.num_expert_slots * max(C, 1)
    experts = 6 * slots * D * cfg.moe_d_ff
    shared = 6 * N_t * D * cfg.moe_d_ff * cfg.num_shared_experts
    return proj + scores + router + experts + shared


def _rwkv_layer_fwd_flops(cfg: ModelConfig, B: int, S: int) -> float:
    from repro_torch.models.rwkv6 import CHUNK, LORA_RANK

    N_t = B * S
    D = cfg.d_model
    K = cfg.ssm_head_dim
    H = D // K
    L = min(CHUNK, S)
    proj = 2 * N_t * D * D * 5 + 2 * N_t * D * LORA_RANK * 2
    wkv = B * H * S * (5 * L * K + 6 * K * K)
    chan = 4 * N_t * D * cfg.d_ff + 2 * N_t * D * D
    return proj + wkv + chan


def _mamba_layer_fwd_flops(cfg: ModelConfig, B: int, S: int) -> float:
    from repro_torch.models.mamba2 import CHUNK, dims

    N_t = B * S
    D = cfg.d_model
    inner, nheads = dims(cfg)
    n = cfg.ssm_state
    P = cfg.ssm_head_dim
    L = min(CHUNK, S)
    conv_ch = inner + 2 * n
    in_proj = 2 * N_t * D * (2 * inner + 2 * n + nheads)
    conv = 2 * N_t * cfg.ssm_conv_width * conv_ch
    ssd = B * nheads * S * (2 * L * n + 3 * L + 2 * L * P + 6 * n * P)
    out_proj = 2 * N_t * inner * D
    return in_proj + conv + ssd + out_proj


def _zamba_shared_fwd_flops(cfg: ModelConfig, B: int, S: int, S_k: int | None = None) -> float:
    N_t = B * S
    D = cfg.d_model
    proj_in = 2 * N_t * 2 * D * D
    return proj_in + _dense_layer_fwd_flops(cfg, B, S, S_k)


def forward_flops(cfg: ModelConfig, B: int, S: int) -> tuple[float, float]:
    """Returns (layer_stack_fwd, head_fwd) global FLOPs for a full forward."""
    V = cfg.padded_vocab
    N_t = B * S
    head = 2 * N_t * cfg.d_model * V + 5 * N_t * V
    f = cfg.family
    if f in ("dense", "vlm"):
        stack = cfg.num_layers * _dense_layer_fwd_flops(cfg, B, S)
        if f == "vlm" and cfg.vision_tokens:
            stack += 2 * B * cfg.vision_tokens * (
                cfg.vision_dim * cfg.d_model + cfg.d_model * cfg.d_model
            )
    elif f == "moe":
        stack = cfg.num_layers * _moe_layer_fwd_flops(cfg, B, S)
    elif f == "rwkv6":
        stack = cfg.num_layers * _rwkv_layer_fwd_flops(cfg, B, S)
    elif f == "hybrid":
        every = cfg.attn_every or 6
        stack = cfg.num_layers * _mamba_layer_fwd_flops(cfg, B, S)
        stack += (cfg.num_layers // every) * _zamba_shared_fwd_flops(cfg, B, S)
    elif f == "encdec":
        T = cfg.encoder_ctx or 1500
        enc = (cfg.num_encoder_layers or cfg.num_layers) * _dense_layer_fwd_flops(cfg, B, T)
        N_t_d = B * S
        D = cfg.d_model
        dec_self = cfg.num_layers * _dense_layer_fwd_flops(cfg, B, S)
        cross = cfg.num_layers * (
            2 * N_t_d * D * (cfg.q_dim + cfg.d_model)  # q proj + out proj
            + 2 * B * T * D * 2 * cfg.kv_dim / cfg.d_model * cfg.d_model  # enc k/v proj
            + 2 * B * cfg.num_heads * S * T * cfg.head_dim * 2
        )
        stack = enc + dec_self + cross
    else:
        raise ValueError(f)
    return stack, head


def decode_flops(cfg: ModelConfig, B: int, S_cache: int) -> float:
    """One decode step (B new tokens), attention against S_cache."""
    f = cfg.family
    V = cfg.padded_vocab
    head = 2 * B * cfg.d_model * V
    if f in ("dense", "vlm", "moe"):
        S_k = S_cache if cfg.sliding_window is None else min(S_cache, cfg.sliding_window)
        if f == "moe":
            per = _moe_layer_fwd_flops(cfg, B, 1)
            # replace the S*S score term with 1*S_k
            per += 2 * B * cfg.num_heads * (S_k - 1) * cfg.head_dim * 2
        else:
            per = _dense_layer_fwd_flops(cfg, B, 1, S_k=S_k)
        return cfg.num_layers * per + head
    if f == "rwkv6":
        D, K = cfg.d_model, cfg.ssm_head_dim
        H = D // K
        per = 2 * B * D * D * 5 + 4 * B * H * K * K + 4 * B * D * cfg.d_ff + 2 * B * D * D
        return cfg.num_layers * per + head
    if f == "hybrid":
        every = cfg.attn_every or 6
        per = _mamba_layer_fwd_flops(cfg, B, 1)
        S_k = min(S_cache, cfg.sliding_window or S_cache)
        sh = _zamba_shared_fwd_flops(cfg, B, 1, S_k=S_k)
        return cfg.num_layers * per + (cfg.num_layers // every) * sh + head
    if f == "encdec":
        T = cfg.encoder_ctx or 1500
        per = _dense_layer_fwd_flops(cfg, B, 1, S_k=S_cache)
        per += 2 * B * cfg.q_dim * cfg.d_model + 2 * B * cfg.num_heads * T * cfg.head_dim * 2
        return cfg.num_layers * per + head
    raise ValueError(f)


# ---------------------------------------------------------------------------
# HBM bytes
# ---------------------------------------------------------------------------

def _param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.models.counting import param_count

    return param_count(cfg) * 2.0  # bf16


def _active_param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.models.counting import active_param_count

    return active_param_count(cfg) * 2.0


def hbm_bytes(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    weight_bytes: float = 2.0,     # int8 serving path: 1.0 (paper C4)
    cache_bytes: float = 2.0,      # int8 KV cache: 1.0
) -> float:
    B, S = shape.global_batch, shape.seq_len
    N_t = B * S
    D, V = cfg.d_model, cfg.padded_vocab
    P_b = _param_bytes(cfg)
    n_params = P_b / 2
    if shape.kind == "train":
        weights = 4 * P_b
        optimizer = 22 * n_params
        stash = 2 * cfg.num_layers * N_t * D * 2
        kv_stream = 0.0
        if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            qb = 1024
            S_k = S
            layers_attn = cfg.num_layers if cfg.family != "hybrid" else (
                cfg.num_layers // (cfg.attn_every or 6)
            )
            kv_stream = 3 * layers_attn * B * (S / qb) * S_k * cfg.kv_dim * 2 * 2
        logits = 12 * N_t * V
        return weights + optimizer + stash + kv_stream + logits
    if shape.kind == "prefill":
        qb = 1024
        kv_stream = cfg.num_layers * B * (S / qb) * S * cfg.kv_dim * 2 * 2 \
            if cfg.family in ("dense", "moe", "vlm") else 0.0
        acts = 8 * cfg.num_layers * N_t * D * 2
        return P_b + acts + kv_stream + 6 * N_t * V
    # decode: weights once (active only for MoE) + cache sweep
    weights = _active_param_bytes(cfg) * (weight_bytes / 2.0)
    cache = 0.0
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        S_c = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
        cache = cfg.num_layers * B * S_c * 2 * cfg.kv_dim * cache_bytes
    elif cfg.family == "hybrid":
        from repro_torch.models.mamba2 import dims

        inner, nheads = dims(cfg)
        every = cfg.attn_every or 6
        S_c = min(S, cfg.sliding_window or 4096)
        cache = (cfg.num_layers // every) * B * S_c * 2 * cfg.kv_dim * cache_bytes
        cache += cfg.num_layers * B * nheads * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2
    elif cfg.family == "rwkv6":
        K = cfg.ssm_head_dim
        H = cfg.d_model // K
        cache = cfg.num_layers * B * H * K * K * 4 * 2
    return weights + cache + 8 * B * V


# ---------------------------------------------------------------------------
# Collective bytes (per chip)
# ---------------------------------------------------------------------------

def collective_bytes(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh_cfg: MeshConfig,
    *,
    preset: str = "tp_sp",
    grad_compression: str = "none",
) -> float:
    from repro_torch.models.counting import param_count

    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    n = param_count(cfg)
    model_ax = mesh_cfg.model
    total_dev = mesh_cfg.num_devices
    dp_size = mesh_cfg.data * (mesh_cfg.pods if mesh_cfg.multi_pod else 1)
    grad_b = 1.0 if grad_compression == "int8_ef" else 4.0
    if shape.kind == "train":
        if preset == "dp":
            # Pure FSDP over all axes: per step the grads reduce-scatter +
            # param all-gather (fwd/bwd): ~3n movements of grad_b/2-byte data.
            return 2 * grad_b * n * (total_dev - 1) / total_dev + 2 * 2.0 * n
        B_loc = max(B // dp_size, 1)
        # gradient reduction (TP-sharded shard per chip) over DP
        grad = 2 * (grad_b * n / model_ax)
        if mesh_cfg.multi_pod:
            grad *= 1.5  # hierarchical: RS/AG in-pod + cross-pod AR of shards
        if preset == "tp":
            # no SP: one all-reduce of the activations per layer per pass
            sp = 3 * cfg.num_layers * 2 * B_loc * S * D * 2 * (model_ax - 1) / model_ax
            return grad + sp
        # SP/TP boundary collectives: ~4 per layer per pass (2 all-gathers +
        # 2 reduce-scatters), 3 passes (fwd/re-fwd/bwd); each moves the local
        # batch slice's activations, (m-1)/m of which crosses links.
        sp = 12 * cfg.num_layers * B_loc * S * D * 2 * (model_ax - 1) / model_ax
        return grad + sp
    B_loc = max(B // dp_size, 1)
    if shape.kind == "prefill":
        if preset == "dp":
            return 0.0
        return 4 * cfg.num_layers * B_loc * S * D * 2
    # decode: per-layer TP all-reduce of (B_loc, 1, D) x ~2 + head gather
    if preset == "dp":
        return 0.0
    per_layer = 2 * B_loc * 1 * D * 4
    head = B_loc * cfg.padded_vocab / model_ax * 4
    return cfg.num_layers * per_layer + head
