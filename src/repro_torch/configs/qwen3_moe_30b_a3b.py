"""qwen3-moe-30b-a3b — 48L d=2048 32H (GQA kv=4) expert d_ff=768,
vocab=151936, MoE 128 experts top-8, q/k norm. [hf:Qwen/Qwen3-30B-A3B; hf]
(A copy of the JAX package's ``repro/configs/qwen3_moe_30b_a3b.py``.)
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    num_shared_experts=0,
    rope_theta=1_000_000.0,
    qk_norm=True,
    activation="silu",
)

SMOKE = FULL.replace(
    name="qwen3-moe-30b-a3b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    moe_d_ff=32,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=2,
    moe_capacity_factor=4.0,
    dtype="float32",
)

register_arch(FULL, SMOKE)
