"""whisper-tiny — enc-dec, 4+4L d=384 6H d_ff=1536 vocab=51865; the conv
audio frontend is a STUB (``batch["frontend"]`` holds precomputed frame
embeddings over a fixed 1500-frame encoder context). [arXiv:2212.04356]
(A copy of the JAX package's ``repro/configs/whisper_tiny.py``.)

Decode runs the decoder alone: its self-attention KV cache and the cross
K/V of ``init_cache``, zeros, as in the reference.
"""

from repro_torch.config import ModelConfig, register_arch

FULL = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    num_encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    vocab_pad_to=32,   # 51865 -> 51872 (16-way vocab TP)
    encoder_ctx=1500,
    norm_type="layernorm",
    mlp_gated=False,
    activation="gelu",
    use_bias=True,
)

SMOKE = FULL.replace(
    name="whisper-tiny-smoke",
    num_layers=2,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    encoder_ctx=24,
    dtype="float32",
)

register_arch(FULL, SMOKE)
