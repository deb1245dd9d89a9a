"""Plain torch versions of the ChaCha20 rows and blocks kernels."""
from __future__ import annotations

import torch

from repro_torch.crypto import chacha20 as _c
from repro_torch.u32 import narrow


def chacha20_xor_rows_ref(keys: torch.Tensor, nonces: torch.Tensor,
                          counters: torch.Tensor,
                          data_rows: torch.Tensor) -> torch.Tensor:
    """XOR (R, 16) rows with per-row keystream blocks; keys (8,) shared
    or (R, 8) per row, nonces (R, 3), counters (R,)."""
    return data_rows ^ _c.chacha20_block_rows(keys, nonces, counters)


def chacha20_xor_blocks_ref(key: torch.Tensor, nonce: torch.Tensor,
                            counter0: int,
                            blocks: torch.Tensor) -> torch.Tensor:
    """XOR (N, 16) blocks with the keystream of one (8,) key and (3,)
    nonce, block i at counter ``(counter0 + i) mod 2^32``."""
    counters = narrow(int(counter0) + torch.arange(
        blocks.shape[0], dtype=torch.int64, device=blocks.device))
    return blocks ^ _c.chacha20_block(key, nonce, counters)
