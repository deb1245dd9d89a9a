"""Host-side Poly1305 (RFC 7539) with Python big ints.

A copy of the reference's ``repro/crypto/poly1305_host.py``: the one-time
authenticator for sealed storage where the MAC runs on the host CPU and
the 128-bit tag is worth the big-int cost.  The device data path uses
the CW-MAC (:mod:`repro_torch.crypto.cwmac`) instead.
"""
from __future__ import annotations

import hmac

P = (1 << 130) - 5


def _le_bytes_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def poly1305(key32: bytes, msg: bytes) -> bytes:
    """16-byte tag of ``msg`` under the one-time 32-byte key (r || s)."""
    if len(key32) != 32:
        raise ValueError(f"poly1305 takes a 32-byte key, got {len(key32)}")
    r = _le_bytes_to_int(key32[:16])
    r &= 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF  # clamp
    s = _le_bytes_to_int(key32[16:])
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i:i + 16]
        n = _le_bytes_to_int(block + b"\x01")
        acc = ((acc + n) * r) % P
    acc = (acc + s) % (1 << 128)
    return acc.to_bytes(16, "little")


def poly1305_verify(key32: bytes, msg: bytes, tag: bytes) -> bool:
    return hmac.compare_digest(poly1305(key32, msg), tag)
