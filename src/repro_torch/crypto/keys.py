"""Session keys per pipeline stage (port of ``repro/crypto/keys.py``).

Session keys are established per edge by the quote-checked handshake and
owned, ratcheted and revoked by
:class:`repro_torch.attest.directory.KeyDirectory`; this module defines
the key *container* and the nonce discipline.  The reference's legacy
per-stage derivation from a root seed is not ported: every edge key of
the port comes from a directory, and the repository's key-hygiene test
admits that derivation only inside ``src/repro/crypto``.  The root seed
itself is: :func:`root_key_from_seed` feeds the sealed checkpoint
store's seal key (:mod:`repro_torch.ckpt.checkpoint`).

Word carrier: ``StageKey.key`` and :meth:`StageKey.nonce` are ``int32``
numpy arrays holding the u32 bit patterns (the reference holds
``uint32``), so they turn into int32-carried tensors without a value
conversion.  Nonces are (domain, chunk_counter) triples; the counter
occupies nonce words 1..2 (64 bits) and :meth:`StageKey.nonce` raises
:class:`NonceExhaustedError` before it can wrap.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

# The chunk counter rides in two u32 nonce words; reusing a (key, nonce)
# pair is a two-time pad, so the guard below is a hard error, not a wrap.
NONCE_COUNTER_BITS = 64
NONCE_COUNTER_MAX = (1 << NONCE_COUNTER_BITS) - 1


class NonceExhaustedError(RuntimeError):
    """The 64-bit chunk counter is exhausted for this key; rotate first
    (KeyDirectory.advance_epoch)."""


@dataclass(frozen=True)
class StageKey:
    key: np.ndarray          # (8,) int32 — ChaCha20 key words (u32 bits)
    stage_id: int

    def nonce(self, chunk_counter: int) -> np.ndarray:
        """(3,) int32 nonce words for a chunk counter: edge keys are
        unique per edge, and the fused enclave kernel re-encrypts under
        the outbound key with the same nonce."""
        if not 0 <= chunk_counter <= NONCE_COUNTER_MAX:
            raise NonceExhaustedError(
                f"chunk counter {chunk_counter} outside [0, 2^"
                f"{NONCE_COUNTER_BITS}) for stage {self.stage_id}: the "
                f"nonce space is spent — advance the key epoch "
                f"(KeyDirectory.advance_epoch) before the counter wraps")
        return np.array([0, chunk_counter & 0xFFFFFFFF,
                         (chunk_counter >> 32) & 0xFFFFFFFF],
                        dtype=np.uint32).view(np.int32)


def key_words(material: bytes) -> np.ndarray:
    """32 bytes -> (8,) int32 key words (little-endian u32 bit patterns)."""
    return np.frombuffer(material[:32], dtype="<i4").copy()


def resolve_key(key, epoch: int = None) -> StageKey:
    """Resolve a StageKey or a KeyDirectory EdgeHandle at an epoch.

    Raw StageKeys are static (epoch-less) and pass through; handles pull
    the live key from the directory — ``epoch=None`` means the edge's
    current epoch."""
    return key if isinstance(key, StageKey) else key.key(epoch)


def current_epoch(key) -> int:
    """The epoch a seal under ``key`` happens in (0 for static keys)."""
    return 0 if isinstance(key, StageKey) else key.epoch


def root_key_from_seed(seed: int) -> bytes:
    """The 32-byte root secret of ``seed`` (the reference's, byte for
    byte): the sealed checkpoint store derives its seal key from it."""
    return hashlib.sha256(f"repro-root-{seed}".encode()).digest()
