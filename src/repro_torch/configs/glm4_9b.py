"""glm4-9b — 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE + GQA, SwiGLU/RMSNorm. [hf:THUDM/glm-4-9b; hf]
(A copy of the JAX package's ``repro/configs/glm4_9b.py``.)

Two KV heads: each serves a group of 16 query heads.  Full attention: the
decode KV cache covers the whole context.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10_000.0,
    activation="silu",
    attn_bias=True,
)

SMOKE = FULL.replace(
    name="glm4-9b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
)

register_arch(FULL, SMOKE)
