"""InternVL2-76B (arXiv:2404.16821) — InternViT + InternLM2 backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Per the assignment
the ViT frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings which a linear projector maps into the LM residual stream.

Copied from the reference's
``repro/configs/internvl2_76b.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, OptimizerConfig

ARCH_ID = "internvl2-76b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    frontend="vision_patches",
    frontend_dim=3200,  # InternViT-6B output width
)

OPTIMIZER = OptimizerConfig(name="adamw")
