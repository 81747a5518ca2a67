"""h2o-danube-1.8b — 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
llama+mistral mix with sliding-window attention. [arXiv:2401.16818; hf]
(A copy of the JAX package's ``repro/configs/h2o_danube_1_8b.py``.)

SWA (window 4096) keeps the decode KV cache a ring buffer of at most 4096
positions.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    rope_theta=10_000.0,
    sliding_window=4096,
    activation="silu",
)

SMOKE = FULL.replace(
    name="h2o-danube-1.8b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    sliding_window=8,
    dtype="float32",
)

register_arch(FULL, SMOKE)
