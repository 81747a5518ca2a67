"""granite-34b — 88L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
llama-style blocks, code model. [arXiv:2405.04324; hf]
(A copy of the JAX package's ``repro/configs/granite_34b.py``.)

The config keeps the default gated MLP (``mlp_gated=True``), so it holds
47.2 B parameters, not the 34 B of its name; the copy keeps it as it is.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10_000.0,
    activation="silu",
)

SMOKE = FULL.replace(
    name="granite-34b-smoke",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
)

register_arch(FULL, SMOKE)
