"""Carter-Wegman polynomial MAC over GF(2^31 - 1), plain torch.

Port of ``repro/crypto/cwmac.py``: the plain version behind the
hand-written CW-MAC tags kernel (``repro_torch/csrc/cwmac.cu``).

    tag = ( sum_i limb_i * r^(n-i) + s ) mod p,   p = 2^31 - 1

over the 16-bit limbs (lo, hi) of each u32 word.  Field elements are
int64 tensors here: a product of two values below 2^31 fits an int64, so
``(a * b) % p`` replaces the reference's 16-bit split multiply — any
exact reduction gives the same tag.  Words enter and tags leave as
int32-carried tensors (tags and keys are below 2^31, so their int32 and
u32 readings agree).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.u32 import lift

P31 = (1 << 31) - 1


def addmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b) % P31


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a*b) mod p for int64 a, b in [0, p)."""
    return (a * b) % P31


def _to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(N,) int32-carried words -> (2N,) int64 16-bit limbs (lo, hi)."""
    w = lift(words)
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(-1)


def to_limbs_batch(words: torch.Tensor) -> torch.Tensor:
    """(B, N) words -> (B, 2N) int64 limbs, per-row layout of _to_limbs."""
    w = lift(words)
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1) \
        .reshape(words.shape[0], -1)


def r_powers_batch(r: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row [r_b^n .. r_b^1]: (B,) keys -> (B, n) int64, log-doubling."""
    asc = r.to(torch.int64).reshape(-1, 1)
    while asc.shape[1] < n:
        asc = torch.cat([asc, mulmod(asc, asc[:, -1:])], dim=1)
    return asc[:, :n].flip(1)


def r_powers(r: torch.Tensor, n: int) -> torch.Tensor:
    """[r^n, r^(n-1), ..., r^1] mod p."""
    return r_powers_batch(r.reshape(1), n)[0]


def mac_batch(words: torch.Tensor, r: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """Row-wise MAC: (B, N) words under (B,) keys -> (B,) int32 tags."""
    limbs = to_limbs_batch(words)
    terms = mulmod(limbs, r_powers_batch(r, limbs.shape[1]))
    # 2N terms below 2^31 sum well inside int64 before one reduction
    acc = terms.sum(dim=1) + s.to(torch.int64).reshape(-1)
    return (acc % P31).to(torch.int32)


def mac2_batch(words: torch.Tensor, r1: torch.Tensor, s1: torch.Tensor,
               r2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Row-wise dual-key MAC: (B, N) words -> (B, 2) tags."""
    return torch.stack([mac_batch(words, r1, s1), mac_batch(words, r2, s2)],
                       dim=-1)


def mac(words: torch.Tensor, r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Single-message tag: (N,) words under scalar keys -> () int32."""
    return mac_batch(words.reshape(1, -1), r.reshape(1), s.reshape(1))[0]


def mac2(words: torch.Tensor, r1, s1, r2, s2) -> torch.Tensor:
    """Two independent M31 evaluations -> (2,) tag (~62-bit bound)."""
    return torch.stack([mac(words, r1, s1), mac(words, r2, s2)])


def mac_reference(words: np.ndarray, r: int, s: int) -> int:
    """Host-side oracle with Python ints over u32 words (tests)."""
    p = P31
    limbs = []
    for w in np.asarray(words).view(np.uint32).astype(np.uint64):
        limbs += [int(w) & 0xFFFF, int(w) >> 16]
    acc = 0
    for m in limbs:
        acc = ((acc + m) * r) % p
    return (acc + s) % p
