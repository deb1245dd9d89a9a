"""Configuration dataclasses of the port (``repro/configs/base.py``).

A served architecture is described by a :class:`ModelConfig`, the serving
geometry by :class:`RunConfig` and the secure-stream data path by
:class:`SecureStreamConfig`.  Plain frozen dataclasses with the
reference's field names.  :class:`ModelConfig` holds the dense family's
fields only; the reference's MoE, SSM, xLSTM, frontend, optimizer and
sharding configs come with the slices that read them (ROADMAP Queue 1
item 15).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

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
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
