"""starcoder2-7b — 32L d=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
LayerNorm + GELU + biases, non-gated MLP, RoPE. [arXiv:2402.19173; hf]
(A copy of the JAX package's ``repro/configs/starcoder2_7b.py``.)

Full attention: the decode KV cache covers the whole context.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=100_000.0,
    norm_type="layernorm",
    mlp_gated=False,
    activation="gelu_tanh",
    use_bias=True,
)

SMOKE = FULL.replace(
    name="starcoder2-7b-smoke",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
)

register_arch(FULL, SMOKE)
