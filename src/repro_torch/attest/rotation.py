"""Epoch rekeying: the HKDF ratchet over session keys.

A ChaCha20 session key must rotate before its 64-bit chunk counter wraps
(repro_torch.crypto.keys guards the hard limit); operationally you rotate far
earlier so a leaked epoch key exposes a bounded window of traffic.  The
ratchet is one-way (HKDF-SHA256 keyed by the handshake transcript), so
epoch N+1 keys reveal nothing about epoch N — forward secrecy per epoch
without re-running the handshake.  `KeyDirectory.advance_epoch` applies
:func:`ratchet_key` to every live session and zeroes its chunk counter.
"""
from __future__ import annotations

import hashlib
import hmac

import numpy as np

from repro_torch.crypto.keys import StageKey, key_words


def hkdf_sha256(ikm: bytes, *, salt: bytes = b"", info: bytes = b"",
                length: int = 32) -> bytes:
    """RFC 5869 extract-then-expand (hashlib/hmac only, no deps)."""
    prk = hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    out, block = b"", b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]),
                         hashlib.sha256).digest()
        out += block
        counter += 1
    return out[:length]


def key_from_bytes(material: bytes, stage_id: int) -> StageKey:
    """32 bytes of KDF output -> a ChaCha20 StageKey ((8,) int32 words
    holding the little-endian u32 bit patterns)."""
    if len(material) < 32:
        raise ValueError(f"key material needs 32 bytes, got {len(material)}")
    return StageKey(key=key_words(material), stage_id=stage_id)


def ratchet_key(key: StageKey, *, epoch: int,
                transcript: bytes = b"") -> StageKey:
    """One-way epoch ratchet: K_{epoch} = HKDF(K_prev, transcript, epoch).

    Binding the handshake transcript keeps two sessions that somehow
    ratcheted from equal material on distinct schedules distinct.
    """
    ikm = np.asarray(key.key).astype("<i4").tobytes()   # the u32 bytes
    material = hkdf_sha256(ikm, salt=transcript,
                           info=b"ss-epoch-%d" % epoch)
    return key_from_bytes(material, key.stage_id)
