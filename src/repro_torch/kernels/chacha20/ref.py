"""Plain torch version of the ChaCha20 rows kernel."""
from __future__ import annotations

import torch

from repro_torch.crypto import chacha20 as _c


def chacha20_xor_rows_ref(keys: torch.Tensor, nonces: torch.Tensor,
                          counters: torch.Tensor,
                          data_rows: torch.Tensor) -> torch.Tensor:
    """XOR (R, 16) rows with per-row keystream blocks; keys (8,) shared
    or (R, 8) per row, nonces (R, 3), counters (R,)."""
    return data_rows ^ _c.chacha20_block_rows(keys, nonces, counters)
