"""The secure data-path configuration (port of ``SecureStreamConfig`` in
``repro/configs/base.py``; the LM configs are not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass


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
