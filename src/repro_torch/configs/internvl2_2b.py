"""internvl2-2b — InternLM2-1.8B LM backbone: 24L d=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553; InternViT frontend is a STUB per the assignment
(``batch["frontend"]`` holds precomputed patch embeddings, dim 1024, 256
tokens).
[arXiv:2404.16821; hf]
(A copy of the JAX package's ``repro/configs/internvl2_2b.py``.)

Causal attention over the patch positions and the text, no window.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    vocab_pad_to=16,   # 92553 -> 92560 (16-way vocab TP)
    rope_theta=1_000_000.0,
    activation="silu",
    vision_tokens=256,
    vision_dim=1024,
)

SMOKE = FULL.replace(
    name="internvl2-2b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vision_tokens=8,
    vision_dim=32,
    dtype="float32",
)

register_arch(FULL, SMOKE)
