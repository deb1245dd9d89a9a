"""Configuration dataclasses of the port (``repro/configs/base.py``).

A served architecture is described by a :class:`ModelConfig`, the serving
geometry by :class:`RunConfig`, the secure-stream data path by
:class:`SecureStreamConfig` and the logical-axis sharding rules by
:class:`ShardingConfig` (read by :mod:`repro_torch.dist.meshctx`).
Plain frozen dataclasses with the reference's field names.
:class:`ModelConfig` holds the dense family's fields only; the
reference's MoE, SSM, xLSTM, frontend and optimizer configs come with
the slices that read them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

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

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    def param_count(self) -> int:
        """Exact parameter count, summed from the port's own param template
        (:func:`repro_torch.models.api.param_template`; no allocation)."""
        from repro_torch.models.api import param_template  # no import cycle
        from repro_torch.models.layers import template_leaves
        return sum(math.prod(s.shape)
                   for s in template_leaves(param_template(self)))


# ---------------------------------------------------------------------------
# Run geometry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


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
    model: ModelConfig
    shape: ShapeConfig
