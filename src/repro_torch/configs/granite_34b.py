"""Granite-34B-Code (arXiv:2405.04324) — llama-arch, MQA.

88L d_model=6144 48H (kv=1, multi-query) d_ff=24576 vocab=49152.

Copied from the reference's
``repro/configs/granite_34b.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, OptimizerConfig

ARCH_ID = "granite-34b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    head_dim=128,
    mlp_type="gelu",  # gpt-bigcode 2-matrix GELU MLP (=> ~34B, not 47B)
    rope_theta=10_000.0,
)

OPTIMIZER = OptimizerConfig(name="adamw")
