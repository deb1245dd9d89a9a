"""Plain torch versions of the ChaCha20 kernels: the AEAD's cipher pass,
per-row blocks and shared-key blocks."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.crypto import chacha20 as _c
from repro_torch.u32 import narrow, repeat_rows

P31 = 0x7FFFFFFF


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


def cipher_pass_ref(key: torch.Tensor, nonces: torch.Tensor,
                    payload: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The AEAD's cipher pass over B items -> (mac_keys (B, 4), ct (B, n)
    or None without a payload).

    key: (8,) shared or (B, 8) per item; nonces: (B, 3); payload: (B, n).
    Item b's keystream runs over counters 0..ceil(n / 16): block 0 gives
    its MAC keys, ``min(w & 0x7FFFFFFF, 0x7FFFFFFE)`` of words 0-3 (the
    reference's ``_clamp``); blocks 1.. are XORed onto its n words."""
    B = nonces.shape[0]
    n = 0 if payload is None else payload.shape[1]
    per_item = 1 + (n + 15) // 16
    counters = torch.arange(per_item, dtype=torch.int32,
                            device=nonces.device).repeat(B)
    keys = key if key.dim() == 1 else repeat_rows(key, per_item)
    ks = _c.chacha20_block_rows(keys, repeat_rows(nonces, per_item),
                                counters).reshape(B, per_item, 16)
    mac_keys = torch.clamp_max(ks[:, 0, :4] & P31, P31 - 1)
    if payload is None:
        return mac_keys, None
    return mac_keys, payload ^ ks[:, 1:].reshape(B, -1)[:, :n]
