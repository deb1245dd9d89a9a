"""Qwen2.5-32B (hf:Qwen family) — dense, GQA, QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.

Copied from the reference's
``repro/configs/qwen2p5_32b.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, OptimizerConfig

ARCH_ID = "qwen2.5-32b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27_648,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

OPTIMIZER = OptimizerConfig(name="adamw")
