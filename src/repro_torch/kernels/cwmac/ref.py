"""Plain torch versions of the CW-MAC partials kernels."""
from __future__ import annotations

import torch

from repro_torch.crypto.cwmac import P31, r_powers_batch, to_limbs_batch


def mac_partials_batch_ref(words: torch.Tensor, r: torch.Tensor,
                           tile_words: int) -> torch.Tensor:
    """Scaled per-tile partials, exactly what the kernel writes.

    words: (B, n) int32-carried; r: (rows,) keys, rows a multiple of B,
    row q MACs words row ``q % B``.  Tile t covers words
    ``[t*tile_words, (t+1)*tile_words)``, and limb l of a row carries
    its absolute power r^(2n - l), so the tag is
    ``(sum_t partial[q, t] + s_q) mod p``.  Returns (rows, T) int32."""
    B, n = words.shape
    rows = r.shape[0]
    T = -(-n // tile_words)
    limbs = to_limbs_batch(words).repeat(rows // B, 1)       # (rows, 2n)
    terms = (limbs * r_powers_batch(r, 2 * n)) % P31
    terms = torch.nn.functional.pad(terms, (0, 2 * T * tile_words - 2 * n))
    return (terms.reshape(rows, T, -1).sum(-1) % P31).to(torch.int32)


def mac_partials_ref(words: torch.Tensor, r: torch.Tensor,
                     tile_words: int) -> torch.Tensor:
    """One message: (n,) words under (K,) keys -> (K, T) scaled partials,
    the batched layout at B = 1 (exactly what the kernel writes)."""
    return mac_partials_batch_ref(words.reshape(1, -1), r, tile_words)
