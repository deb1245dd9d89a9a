"""Plain torch version of the CW-MAC tags kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.crypto.cwmac import P31, r_powers_batch, to_limbs_batch


def mac_tags_ref(words: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                 block_words: int = 0) -> torch.Tensor:
    """(B, n) int32-carried words under (B, K) keys r, s -> (B, K) int32
    tags, split as the kernel splits a row.

    The row is left-padded with zero words to G blocks of ``block_words``
    (0: one block of the whole row); leading zeros leave the polynomial
    unchanged.  Block g's partial carries each limb's power of r within
    the block, and the blocks fold by Horner with X = r^(2 block_words):
    ``tag = (sum_g V_g X^(G-1-g) + s) mod p``, the same value for every
    split.  Keys are read as signed int32 mod p, as
    :func:`repro_torch.crypto.cwmac.mac_batch` reads them."""
    B, n = words.shape
    K = r.shape[1]
    bw = block_words or max(n, 1)
    G = max(1, -(-n // bw))
    limbs = to_limbs_batch(F.pad(words, (G * bw - n, 0))).reshape(B, 1, G, -1)
    rr = r.to(torch.int64) % P31                              # (B, K)
    within = r_powers_batch(rr.reshape(-1), 2 * bw).reshape(B, K, 1, -1)
    V = ((limbs * within) % P31).sum(-1) % P31                 # (B, K, G)
    X = within[..., 0, 0].reshape(-1)                          # r^(2 bw)
    outer = torch.cat([r_powers_batch(X, G)[:, 1:],
                       torch.ones((B * K, 1), dtype=torch.int64,
                                  device=words.device)], dim=1)
    acc = ((V.reshape(B * K, G) * outer) % P31).sum(-1)
    tags = (acc + s.to(torch.int64).reshape(-1)) % P31
    return tags.reshape(B, K).to(torch.int32)
