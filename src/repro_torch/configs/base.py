"""Configuration dataclasses of the port (``repro/configs/base.py``).

An architecture is described by a :class:`ModelConfig`, the training /
serving geometry by :class:`RunConfig` (shape, optimizer, remat,
microbatches, seed), the optimizer by :class:`OptimizerConfig`,
the secure-stream data path by :class:`SecureStreamConfig` and the
logical-axis sharding rules by :class:`ShardingConfig` (read by
:mod:`repro_torch.dist.meshctx`).  Plain frozen dataclasses with the
reference's field names; every model family's sub-config
(:class:`MoEConfig`, :class:`SSMConfig`, :class:`XLSTMConfig`) is the
reference's, field for field.

The port adds fields of its own for models the reference does not run
(DeepSeek-V3's block, as Moonlight-16B-A3B has it): latent attention
(:class:`MLAConfig`, ``ModelConfig.mla``), leading dense layers ahead of
an MoE stack (``ModelConfig.first_dense_layers``), and the MoE's sigmoid
router with its correction bias, routed scale, shared experts and
dropless dispatch (:class:`SigmoidMoEConfig`, ``ModelConfig.sigmoid_moe``).
Each default is the reference's model, so the ten configs it has stay as
they are.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model-family sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    # Per-expert hidden width (the assignment tables give d_ff per expert).
    d_expert: int
    # Fixed-capacity routing: capacity per expert is
    #   ceil(tokens * top_k / num_experts * capacity_factor), 8-aligned.
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Load-balancing auxiliary loss weight (Switch-style).
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SigmoidMoEConfig:
    """DeepSeek-V3's MoE over :class:`MoEConfig`'s experts (the port's own;
    the reference has none): each expert scored by a sigmoid, a token's
    ``top_k`` chosen by score plus a per-expert f32 bias
    (``e_score_correction_bias``, ``topk_method`` noaux_tc), weighted by
    the chosen unbiased scores, renormalised (``norm_topk_prob``) and
    times ``routed_scale`` (``routed_scaling_factor``); every assignment
    computed (no capacity: ``capacity_factor`` is unread); and
    ``num_shared_experts`` experts that every token passes through, run as
    one SwiGLU of ``num_shared_experts * d_expert``."""

    routed_scale: float
    num_shared_experts: int


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3), without a query
    latent: keys and values come up from a normed latent of
    ``kv_lora_rank`` values a token; each head's query and key have
    ``qk_nope_head_dim`` dims without position and ``qk_rope_head_dim``
    rotary dims (the rotary key is one for all heads), its value
    ``v_head_dim``."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style state-space block configuration."""

    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    headdim: int = 64
    chunk_size: int = 256  # chunkwise-parallel scan block


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack configuration (alternating mLSTM / sLSTM)."""

    # Indices (mod pattern length) that are sLSTM; remainder are mLSTM.
    slstm_every: int = 2          # every 2nd block is sLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    chunk_size: int = 256         # chunkwise-parallel mLSTM scan block


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"      # swiglu (3 mats) | gelu (2 mats)
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # hybrid: attention layer period (Zamba-style shared attention block).
    attn_every: int = 0           # 0 -> attention in every layer (or none for ssm)
    shared_attention: bool = False

    # Modality frontend stub: "none" | "vision_patches" | "audio_frames".
    frontend: str = "none"
    frontend_dim: int = 0         # embedding dim of precomputed patch/frame inputs

    # Whether attention is full quadratic (drives the long_500k skip rule).
    attention_free: bool = False

    # ---- the port's own fields; the defaults are the reference's models
    # latent attention in place of the q/k/v projections (head_dim is then
    # its q/k head dim)
    mla: Optional[MLAConfig] = None
    # moe: this many dense layers (an MLP of d_ff) ahead of the MoE layers,
    # counted in num_layers (first_k_dense_replace)
    first_dense_layers: int = 0
    # moe: DeepSeek-V3's routing of moe's experts in place of the
    # reference's softmax over capacity-bound ones
    sigmoid_moe: Optional[SigmoidMoEConfig] = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run the 500k-token long-context decode."""
        return self.family in ("ssm", "hybrid") or self.attention_free

    def param_count(self) -> int:
        """Exact parameter count, summed from the port's own param template
        (:func:`repro_torch.models.api.param_template`; no allocation)."""
        from repro_torch.models.api import param_template  # no import cycle
        from repro_torch.models.layers import template_leaves
        return sum(math.prod(s.shape)
                   for s in template_leaves(param_template(self)))

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only top_k experts)."""
        full = self.param_count()
        if self.moe is None:
            return full
        expert_p = 3 * self.d_model * self.moe.d_expert
        dead = (self.num_layers - self.first_dense_layers) \
            * (self.moe.num_experts - self.moe.top_k) * expert_p
        return full - dead


# ---------------------------------------------------------------------------
# Run geometry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str                     # train_4k | prefill_32k | ...
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"           # adamw | adafactor | sgdm
    lr: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # Gradient compression: "none" | "fp16" (the accumulated gradients
    # rounded through float16, as the reference's train step does).
    grad_compression: str = "none"


@dataclass(frozen=True)
class SecureStreamConfig:
    """The paper's technique, as data-path configuration."""

    # Security mode, mirroring the paper's three Fig-6 configurations:
    #   "plain"      -- cleartext end to end (baseline, unsafe)
    #   "encrypted"  -- AEAD-sealed at rest / on the wire, decrypted *outside*
    #                   the enclave kernels (trusts the operator)
    #   "enclave"    -- sealed everywhere; plaintext exists only inside the
    #                   fused enclave kernel (registers)
    mode: str = "enclave"
    chunk_bytes: int = 65_536      # paper Fig 4 knee: 64 KB
    mac: str = "cwmac"             # cwmac | none (poly1305 reserved for host)
    seal_checkpoints: bool = True
    seal_pp_boundaries: bool = True


@dataclass(frozen=True)
class ShardingConfig:
    """Logical-axis -> mesh-axis rules (MaxText-style)."""

    # Each logical axis maps to a tuple of mesh axes tried in order; the
    # partitioner shards on the first whose size divides the dim (padding
    # is allowed as a fallback when `allow_uneven`).
    rules: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("batch", ("pod", "data")),
        ("seq", ()),               # sequence sharding enabled per-shape
        ("seq_res", ()),           # SP residual stream (enable per-arch)
        ("moe_ff", ()),            # FSDP storage of expert weights
        ("embed", ()),             # activation d_model: replicated
        ("vocab", ("model",)),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("mlp", ("model",)),
        ("experts", ("model",)),
        ("kv_seq", ()),            # decode KV cache sequence dim
        ("zero", ("data",)),       # optimizer-state sharding axis
    )
    allow_uneven: bool = True

    def with_rule(self, name: str, axes: Tuple[str, ...]) -> "ShardingConfig":
        rules = tuple((k, axes if k == name else v) for k, v in self.rules)
        return dataclasses.replace(self, rules=rules)

    def lookup(self) -> Dict[str, Tuple[str, ...]]:
        return dict(self.rules)


@dataclass(frozen=True)
class RunConfig:
    """The reference's ``sharding``, ``secure``, ``dtype`` and
    ``param_dtype`` fields are left out: no code of the one-card port
    (nor, for the dtypes, of the reference) reads them."""

    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()
    remat: str = "full"            # none | full | selective
    microbatches: int = 1          # grad-accumulation microbatches
    seed: int = 0


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs: same family, tiny dims, run on the CPU.
# ---------------------------------------------------------------------------


def reduce_for_smoke(m: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-runnable config of the same family
    (the reference's dims: 2 layers (7 for a hybrid), d_model 64, 4 heads
    of 16, d_ff 128, vocab 256, and each family's small sub-config).  The
    port's own fields: at most one leading dense layer ahead of the 2;
    latent attention at a latent of 32, 16 + 8 q/k dims and 16 v dims; at
    most 1 shared expert; the router's kind carried."""
    dense = min(m.first_dense_layers, 1)
    kw: Dict[str, Any] = dict(
        arch_id=m.arch_id + "-smoke",
        family=m.family,
        num_layers=dense + min(m.num_layers - m.first_dense_layers,
                               2 if m.family != "hybrid" else 7),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(m.num_kv_heads, 4) if m.num_kv_heads > 1 else 1,
        d_ff=128 if m.d_ff else 0,
        vocab_size=256,
        head_dim=16 if m.mla is None else 24,
        qkv_bias=m.qkv_bias,
        mlp_type=m.mlp_type,
        tie_embeddings=m.tie_embeddings,
        attn_every=m.attn_every,
        shared_attention=m.shared_attention,
        frontend=m.frontend,
        frontend_dim=32 if m.frontend != "none" else 0,
        attention_free=m.attention_free,
        first_dense_layers=dense,
    )
    if m.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
    if m.moe is not None:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_expert=32,
                              capacity_factor=m.moe.capacity_factor)
    if m.sigmoid_moe is not None:
        kw["sigmoid_moe"] = dataclasses.replace(
            m.sigmoid_moe,
            num_shared_experts=min(m.sigmoid_moe.num_shared_experts, 1))
    if m.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=16, conv_width=4, expand=2, headdim=16,
                              chunk_size=16)
    if m.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(slstm_every=m.xlstm.slstm_every,
                                  chunk_size=16)
    return ModelConfig(**kw)
