"""rwkv6-7b (Finch) — 32L d=4096, attention-free, d_ff=14336 vocab=65536,
head size 64, data-dependent decay. [arXiv:2404.05892; hf]
(A copy of the JAX package's ``repro/configs/rwkv6_7b.py``.)

O(1) recurrent state per layer; the rwkv6_scan kernel is the hot spot.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # d_model / ssm_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_head_dim=64,
)

SMOKE = FULL.replace(
    name="rwkv6-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_head_dim=16,
    dtype="float32",
)

register_arch(FULL, SMOKE)
