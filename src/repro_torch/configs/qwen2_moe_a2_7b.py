"""qwen2-moe-a2.7b — 24L d=2048 16H (GQA kv=16) expert d_ff=1408,
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
(A copy of the JAX package's ``repro/configs/qwen2_moe_a2_7b.py``.)
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    moe_pad_to=16,          # 60 experts -> 64 slots (16-way EP divisibility)
    rope_theta=1_000_000.0,
    attn_bias=True,
    activation="silu",
)

SMOKE = FULL.replace(
    name="qwen2-moe-a2.7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=48,
    moe_d_ff=48,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=4,
    num_shared_experts=2,
    moe_capacity_factor=4.0,
    moe_pad_to=5,           # 8 -> 10 slots: exercises the padding path on CPU
    dtype="float32",
)

register_arch(FULL, SMOKE)
