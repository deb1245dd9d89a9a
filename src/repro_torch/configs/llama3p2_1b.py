"""Llama-3.2-1B (hf:meta-llama/Llama-3.2-1B) — small dense llama3.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.  Copied from the
reference's ``repro/configs/llama3p2_1b.py``.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama3.2-1b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=500_000.0,
)
