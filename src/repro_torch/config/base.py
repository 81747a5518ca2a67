"""Configuration of the PyTorch port: ``ModelConfig``, ``ShapeConfig``
(and the assigned ``SHAPES``), ``MeshConfig``, ``TrainConfig``,
``ServeConfig``, the REXA VM's ``VMConfig`` and the ``RunConfig`` bundle.

Copies of the classes of ``repro.config.base`` with the same fields and
defaults (the port imports nothing of the JAX package).  Frozen, so a
config can key the per-config interpreter and kernel caches.
``MeshConfig`` is plain data here: ``RunConfig`` holds one, and the mesh
logic that reads it comes with the port's sharding.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (the reference's ``ModelConfig``).

    ``family`` selects the block layout: "dense" (pre-norm decoder
    transformer, GQA + RoPE, optional sliding window), "moe" (dense
    attention + mixture-of-experts MLP), "vlm" (dense, with stub patch
    embeddings prepended), "rwkv6" (attention-free RWKV6 time/channel mix),
    "hybrid" (zamba2: Mamba2 layers + a weight-shared attention block) and
    "encdec" (whisper).
    """

    name: str
    family: str

    # Common transformer dims.
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0             # 0 -> = num_heads (MHA)
    head_dim: int = 0                 # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # SWA window (h2o-danube, zamba2-long)
    activation: str = "silu"
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    mlp_gated: bool = True            # SwiGLU vs plain 2-matrix MLP
    qk_norm: bool = False             # qwen3-style per-head q/k RMSNorm
    tie_embeddings: bool = False
    use_bias: bool = False
    attn_bias: bool = False           # qkv bias (qwen2-style) without mlp bias

    # MoE.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert FF dim (0 -> d_ff)
    first_dense_layers: int = 0       # leading dense layers before MoE starts
    router_aux_loss_coef: float = 0.001
    moe_capacity_factor: float = 1.25 # tokens-per-expert headroom (drops above)
    moe_pad_to: int = 1               # pad expert slots to a multiple
    moe_groups: int = 1               # grouped dispatch shards

    vocab_pad_to: int = 1             # pad embedding rows for vocab sharding

    @property
    def num_expert_slots(self) -> int:
        e, m = self.num_experts, self.moe_pad_to
        return ((e + m - 1) // m) * m if e else 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    # SSM / RWKV.
    ssm_state: int = 0                # Mamba2 state dim per head
    ssm_head_dim: int = 64            # RWKV6 / Mamba2 head size
    ssm_expand: int = 2               # Mamba2 inner expansion
    ssm_conv_width: int = 4           # Mamba2 depthwise conv width
    attn_every: int = 0               # hybrid: shared-attn block period (layers)

    # Encoder-decoder (whisper).
    num_encoder_layers: int = 0
    encoder_ctx: int = 0              # fixed encoder sequence (audio frames)

    # VLM (internvl2): stub frontend supplies precomputed patch embeddings.
    vision_tokens: int = 0            # patch tokens prepended in prefill
    vision_dim: int = 0               # stub frontend embedding dim

    # Numerics.
    dtype: str = "bfloat16"           # activation/param compute dtype
    kv_cache_dtype: str = "auto"      # "auto" (= dtype) | "int8" (paper C4)
    remat: bool = True                # per-layer activation checkpointing

    # Paper integration: quantized fixed-point serving path (C4/C5).
    quantized_serve: bool = False     # use the fixmatmul int8 path in decode
    lut_activation: bool = False      # use LUT sigmoid/silu (paper Alg. 2)

    def __post_init__(self):
        if self.num_kv_heads == 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameter count N (all experts for MoE)."""
        from repro_torch.models.counting import param_count
        return param_count(self)

    def active_param_count(self) -> int:
        """Active-per-token parameter count (MoE: top-k experts)."""
        from repro_torch.models.counting import active_param_count
        return active_param_count(self)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        return cls(**d)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) cell.  ``kind``: "train",
    "prefill" or "decode" (one new token against a KV cache of
    ``seq_len``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def shape_runs_for(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention: SSM / hybrid / SWA only."""
    if shape.name != "long_500k":
        return True
    if model.family in ("rwkv6", "hybrid"):
        return True
    return model.sliding_window is not None


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description (plain data; ``multi_pod`` adds the
    outer "pod" axis)."""

    multi_pod: bool = False
    pods: int = 2
    data: int = 16
    model: int = 16

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.multi_pod else (self.data, self.model)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """Axes carrying batch data-parallelism."""
        return ("pod", "data") if self.multi_pod else ("data",)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    lr_schedule: str = "cosine"       # constant | linear | cosine
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer: str = "adamw"          # adamw | lion | sgd
    microbatches: int = 1             # gradient accumulation
    seed: int = 0
    z_loss: float = 1e-4
    # Distributed-optimization tricks (paper C4 applied to gradients).
    grad_compression: str = "none"    # none | int8_ef  (error-feedback int8)
    # Resilience (paper C7/C8).
    slice_steps: int = 10             # steps per LSA-scheduled slice
    slice_deadline_s: float = 0.0     # 0 = no deadline (watchdog off)
    ckpt_every_slices: int = 5
    replica_vote: bool = False        # per-pod loss voting (SDC detection)


@dataclass(frozen=True)
class ServeConfig:
    max_decode_steps: int = 32
    temperature: float = 0.0          # 0 = greedy
    quantized: bool = False           # fixed-point fixmatmul path
    long_window: int = 4096           # hybrid shared-attn window at long ctx


@dataclass(frozen=True)
class VMConfig:
    """REXA VM configuration (paper Tab. 7 names: CS/DS/RS/FS sizes)."""

    cs_size: int = 4096               # code segment cells (bytes in paper; int32 here)
    ds_size: int = 256                # data stack depth
    rs_size: int = 128                # return stack depth
    fs_size: int = 64                 # loop stack depth
    mem_size: int = 4096              # vector/data memory cells (DIOS window)
    max_tasks: int = 8                # multi-tasking slots (Alg. 6 mask supports 16)
    steps_per_slice: int = 256        # vmloop micro-slice instruction budget
    double_words: bool = True         # 32-bit cells (paper: optional doubles)
    ensemble: int = 1                 # parallel VM instances (majority vote if >1)
    out_ring_size: int = 256          # output ring entries ([kind,value] pairs)
    max_vec: int = 64                 # vector-op window (paper ANNs <= 64/layer)
    us_per_instr: int = 10            # calibrated instr time for virtual clock
    mbox_size: int = 32               # per-node mailbox ring entries (fleet send/receive)


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    vm: VMConfig = field(default_factory=VMConfig)
    # Parallelism preset: "tp_sp" (TP over "model" + sequence-parallel
    # activations), "tp" (TP without SP) or "dp" (pure (FS)DP).
    parallelism: str = "tp_sp"

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
