"""zamba2-1.2b — 38 Mamba2 blocks d=2048 with a weight-shared attention
block (32H, kv=32, concat[hidden, embed] input) applied every 6 layers;
ssm_state=64. [arXiv:2411.15242; hf]
(A copy of the JAX package's ``repro/configs/zamba2_1_2b.py``.)

The shared block attends with ``sliding_window``, None here: causal over
the whole prefill, and over the whole cache in decode.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    attn_every=6,
    activation="gelu",
)

SMOKE = FULL.replace(
    name="zamba2-1.2b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    attn_every=2,
    dtype="float32",
)

register_arch(FULL, SMOKE)
