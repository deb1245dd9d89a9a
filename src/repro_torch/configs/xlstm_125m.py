"""xLSTM-125M (arXiv:2405.04517) — alternating sLSTM + mLSTM blocks.

12L d_model=768 4H d_ff=0 vocab=50304.  Attention-free (recurrent) =>
sub-quadratic; runs the long_500k shape.

Copied from the reference's
``repro/configs/xlstm_125m.py`` (its ``SHARDING``
and ``zero_sharding`` are not ported: the port runs on one card).
"""
from repro_torch.configs.base import ModelConfig, OptimizerConfig, XLSTMConfig

ARCH_ID = "xlstm-125m"

MODEL = ModelConfig(
    arch_id=ARCH_ID,
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=192,
    xlstm=XLSTMConfig(slstm_every=2, chunk_size=256),
    attention_free=True,
)

OPTIMIZER = OptimizerConfig(name="adamw")
