"""The JAX package's ``moonshot-v1-16b-a3b`` MoE, which cites
hf:moonshotai/Moonlight-16B-A3B but is not that model as published:
48L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=163840, MoE 64e
top-6 with a softmax router and capacity 1.25, plain MHA at D 128, no
shared experts, no dense first layer.  Moonlight as published (27
layers, latent attention, a sigmoid router, 2 shared experts, dropless)
is :mod:`repro_torch.configs.moonlight_16b_a3b`.

Copied from the reference's
``repro/configs/moonshot_v1_16b_a3b.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, OptimizerConfig

ARCH_ID = "moonshot-v1-16b-a3b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=163_840,
    head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
)

OPTIMIZER = OptimizerConfig(name="adamw")
