"""Public ops: ChaCha20 keystream XOR over per-row (key, nonce, counter)
rows, and over consecutive blocks under one key and nonce.

Replaces the reference's ``repro/kernels/chacha20/ops.py``:
:func:`xor_rows` (Pallas ``_chacha_rows_kernel``) and
:func:`encrypt_words` / :func:`decrypt_words` over :func:`xor_blocks`
(Pallas ``_chacha_kernel``).  A CPU tensor runs the plain torch version
(:mod:`.ref`); a CUDA tensor launches ``ss_chacha20_xor_rows`` /
``ss_chacha20_xor_blocks`` (``repro_torch/csrc/chacha20.cu``) or raises.
The reference pads to a whole tile of rows and slices the tail off; here
the grid is rounded up instead and the kernel masks the rows past the
end, so only the flat words of :func:`encrypt_words` are padded, to
whole 16-word blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.chacha20.ref import (chacha20_xor_blocks_ref,
                                              chacha20_xor_rows_ref)
from repro_torch.u32 import MASK

KERNEL = build.Kernel("ss_chacha20_xor_rows", [
    build.VOIDP, build.INT, build.VOIDP, build.VOIDP, build.VOIDP,
    build.VOIDP, build.LONG, build.VOIDP])
BLOCKS_KERNEL = build.Kernel("ss_chacha20_xor_blocks", [
    build.VOIDP, build.VOIDP, build.U32, build.VOIDP, build.VOIDP,
    build.LONG, build.VOIDP])


def xor_rows(key: torch.Tensor, nonces: torch.Tensor, counters: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """Per-row keystream XOR over (R, 16) int32-carried rows.

    key: (8,) shared (passed with row stride 0, never materialised per
    row) or (R, 8) per-row; nonces: (R, 3); counters: (R,)."""
    R = rows.shape[0] if rows.dim() == 2 else -1
    dev = rows.device
    build.check_words("rows", rows, [(None, 16)], dev, align16=True)
    build.check_words("key", key, [(8,), (R, 8)], dev)
    build.check_words("nonces", nonces, [(R, 3)], dev)
    build.check_words("counters", counters, [(R,)], dev)
    if dev.type == "cpu":
        return chacha20_xor_rows_ref(key, nonces, counters, rows)
    build.require_cuda(rows)
    out = torch.empty_like(rows)
    if R:
        KERNEL(key.data_ptr(), 8 if key.dim() == 2 else 0,
               nonces.data_ptr(), counters.data_ptr(), rows.data_ptr(),
               out.data_ptr(), R, build.stream_of(rows))
    return out


def xor_blocks(key: torch.Tensor, nonce: torch.Tensor, counter0: int,
               blocks: torch.Tensor) -> torch.Tensor:
    """(N, 16) int32-carried blocks XOR the keystream of a shared (8,)
    key and (3,) nonce; block i runs at counter ``(counter0 + i) mod
    2^32``, as the reference's u32 add wraps."""
    dev = blocks.device
    build.check_words("blocks", blocks, [(None, 16)], dev, align16=True)
    build.check_words("key", key, [(8,)], dev)
    build.check_words("nonce", nonce, [(3,)], dev)
    counter0 = int(counter0) & MASK
    if dev.type == "cpu":
        return chacha20_xor_blocks_ref(key, nonce, counter0, blocks)
    build.require_cuda(blocks)
    out = torch.empty_like(blocks)
    if blocks.shape[0]:
        BLOCKS_KERNEL(key.data_ptr(), nonce.data_ptr(), counter0,
                      blocks.data_ptr(), out.data_ptr(), blocks.shape[0],
                      build.stream_of(blocks))
    return out


def encrypt_words(key: torch.Tensor, nonce: torch.Tensor,
                  words: torch.Tensor, counter0: int = 1) -> torch.Tensor:
    """XOR flat (n,) words with the keystream from ``counter0`` (padded
    to whole blocks for the kernel, sliced back to n).  Involutive."""
    n = words.shape[0]
    n_blocks = (n + 15) // 16
    padded = F.pad(words, (0, n_blocks * 16 - n)).reshape(n_blocks, 16)
    return xor_blocks(key, nonce, counter0, padded).reshape(-1)[:n]


decrypt_words = encrypt_words   # XOR stream cipher is its own inverse
