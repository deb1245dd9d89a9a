"""ChaCha20 in plain torch (port of ``repro/crypto/chacha20.py``).

The plain version behind the hand-written ChaCha20 CUDA kernels
(``repro_torch/csrc/chacha20.cu``: the AEAD's cipher pass and the row and
block entries): the same per-row block function, written on int64-lifted
u32 words (every add and rotate is masked to 32 bits).  Inputs and
outputs are int32-carried words (:mod:`repro_torch.u32`).  RFC 7539
vectors are checked in the tests.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.u32 import MASK, lift, narrow

CONSTANTS = (0x61707865, 0x3320646e, 0x79622d32, 0x6b206574)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & MASK) | (x >> (32 - n))


def _quarter(s: List[torch.Tensor], a: int, b: int, c: int, d: int) -> None:
    sa, sb, sc, sd = s[a], s[b], s[c], s[d]
    sa = (sa + sb) & MASK
    sd = _rotl(sd ^ sa, 16)
    sc = (sc + sd) & MASK
    sb = _rotl(sb ^ sc, 12)
    sa = (sa + sb) & MASK
    sd = _rotl(sd ^ sa, 8)
    sc = (sc + sd) & MASK
    sb = _rotl(sb ^ sc, 7)
    s[a], s[b], s[c], s[d] = sa, sb, sc, sd


def chacha20_block_rows(key: torch.Tensor, nonces: torch.Tensor,
                        counters: torch.Tensor) -> torch.Tensor:
    """Keystream blocks with an independent (nonce, counter) per row.

    key: (8,) shared or (N, 8) per-row keys; nonces: (N, 3); counters:
    (N,); all int32-carried.  Returns (N, 16) int32-carried keystream."""
    N = counters.shape[0]
    dev = counters.device
    key = lift(key)
    nonces = lift(nonces)
    init = [torch.full((N,), c, dtype=torch.int64, device=dev)
            for c in CONSTANTS]
    init += [key[:, i] if key.dim() == 2 else key[i].expand(N)
             for i in range(8)]
    init.append(lift(counters))
    init += [nonces[:, i] for i in range(3)]
    s = list(init)
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return narrow(torch.stack([a + b for a, b in zip(s, init)], dim=-1))


def chacha20_block(key: torch.Tensor, nonce: torch.Tensor,
                   counters: torch.Tensor) -> torch.Tensor:
    """key: (8,); nonce: (3,); counters: (N,) -> (N, 16) keystream."""
    nonces = nonce.reshape(1, 3).expand(counters.shape[0], 3)
    return chacha20_block_rows(key, nonces, counters)


def keystream(key: torch.Tensor, nonce: torch.Tensor, n_words: int,
              counter0: int = 1) -> torch.Tensor:
    """Flat keystream of n_words words (padded up to whole blocks)."""
    n_blocks = (n_words + 15) // 16
    counters = narrow(counter0 + torch.arange(n_blocks, dtype=torch.int64,
                                              device=key.device))
    return chacha20_block(key, nonce, counters).reshape(-1)[:n_words]


def encrypt_words(key: torch.Tensor, nonce: torch.Tensor,
                  words: torch.Tensor, counter0: int = 1) -> torch.Tensor:
    """XOR a flat (N,) word tensor with the keystream. Involutive."""
    return words ^ keystream(key, nonce, words.shape[0], counter0)


decrypt_words = encrypt_words  # XOR stream cipher is its own inverse
