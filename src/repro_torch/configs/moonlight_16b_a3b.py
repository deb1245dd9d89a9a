"""Moonlight-16B-A3B as published (hf:moonshotai/Moonlight-16B-A3B,
``config.json``, ``model_type`` ``deepseek_v3``).

27L d_model=2048 16H vocab=163840: the first layer dense (SwiGLU 11,264,
``first_k_dense_replace`` 1), then 26 MoE layers of 64 routed experts of
1,408 (top-6) beside 2 shared experts, a sigmoid router whose correction
bias only chooses the experts (``topk_method`` noaux_tc, one group), the
chosen scores renormalised and scaled by 2.446, no capacity.  Attention
is latent (MLA): ``kv_lora_rank`` 512, no query latent, q/k 128 + 64
rotary dims, v 128; rope theta 50,000; 15,960,110,208 parameters.

The port's own config: the reference has no counterpart (its
``moonshot-v1-16b-a3b`` is another model, 48 layers of plain MHA), so it
is not in ``ARCH_IDS``.  Serving only: ``models.api.forward`` and
``loss_fn`` refuse latent attention.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, SigmoidMoEConfig)

ARCH_ID = "moonlight-16b-a3b"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11_264,
    vocab_size=163_840,
    head_dim=192,
    rope_theta=50_000.0,
    rms_eps=1e-5,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    first_dense_layers=1,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
    sigmoid_moe=SigmoidMoEConfig(routed_scale=2.446, num_shared_experts=2),
)

OPTIMIZER = OptimizerConfig(name="adamw")
