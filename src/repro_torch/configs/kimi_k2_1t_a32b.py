"""Kimi K2 — trillion-parameter MoE (arXiv:2501.kimi2, paper-table).

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840, MoE 384e top-8.

Copied from the reference's
``repro/configs/kimi_k2_1t_a32b.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, OptimizerConfig

ARCH_ID = "kimi-k2-1t-a32b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=163_840,
    head_dim=112,
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048),
    rope_theta=50_000.0,
)

# 1T-param training is HBM-gated: a factored, stateless-momentum optimizer
# (the reference also shards its state ZeRO-style over the data axis).
OPTIMIZER = OptimizerConfig(name="adafactor")
