"""Zamba2-1.2B (arXiv:2411.15242) — Mamba2 backbone + shared attention block.

38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64 vocab=32000.  A single
weight-shared attention+FFN block is invoked every 6th layer (Zamba's trick);
all other layers are Mamba2.  Hybrid => sub-quadratic; runs long_500k.

Copied from the reference's
``repro/configs/zamba2_1p2b.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, OptimizerConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    head_dim=64,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, headdim=64),
    attn_every=6,
    shared_attention=True,
)

OPTIMIZER = OptimizerConfig(name="adamw")
