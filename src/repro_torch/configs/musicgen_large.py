"""MusicGen-Large (arXiv:2306.05284) — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.  Per the assignment the
EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings alongside codebook token ids.

Copied from the reference's
``repro/configs/musicgen_large.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, OptimizerConfig

ARCH_ID = "musicgen-large"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    frontend="audio_frames",
    frontend_dim=128,  # EnCodec latent frame width
    rope_theta=10_000.0,
)

OPTIMIZER = OptimizerConfig(name="adamw")
