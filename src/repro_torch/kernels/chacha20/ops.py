"""Public ops: the AEAD's ChaCha20 cipher pass, one launch a call, and
ChaCha20 keystream XOR over per-row (key, nonce, counter) rows and over
consecutive blocks under one key and nonce.

Replaces the reference's ``repro/kernels/chacha20/ops.py`` together with
the operand glue of ``repro/crypto/aead.py`` around it.
:func:`cipher_pass` (B items: the batched seal/open and MAC-key
derivation; Pallas ``_chacha_rows_kernel`` there) and
:func:`cipher_pass_message` (one message: the scalar seal/open and
``derive_mac_keys``; Pallas ``_chacha_kernel`` there) launch
``ss_chacha20_cipher_pass`` (``repro_torch/csrc/chacha20.cu``) once: it
reads the caller's key, nonces and payload as they are, computes each
block's counter, and writes the ciphertext in the payload's layout and
the clamped MAC keys.  :func:`xor_rows` and :func:`xor_blocks` (with
:func:`encrypt_words` over it) keep the reference ops' general
coordinates (``ss_chacha20_xor_rows`` / ``ss_chacha20_xor_blocks``).  A
CPU tensor runs the plain torch version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.chacha20.ref import (chacha20_xor_blocks_ref,
                                              chacha20_xor_rows_ref,
                                              cipher_pass_ref)
from repro_torch.u32 import MASK

PASS_KERNEL = build.Kernel("ss_chacha20_cipher_pass", [
    build.VOIDP, build.INT, build.VOIDP, build.VOIDP, build.INT,
    build.VOIDP, build.VOIDP, build.LONG, build.LONG, build.VOIDP])
#: the pass indexes its blocks, MAC-key blocks included, in 31 bits.  A
#: sealed checkpoint of llama3.2-1b (~151k rows of 4,096 words) is 3.9e7
#: blocks, the largest batch any path makes, so one launch covers it
MAX_PASS_BLOCKS = 2 ** 31 - 1
KERNEL = build.Kernel("ss_chacha20_xor_rows", [
    build.VOIDP, build.INT, build.VOIDP, build.VOIDP, build.VOIDP,
    build.VOIDP, build.LONG, build.VOIDP])
BLOCKS_KERNEL = build.Kernel("ss_chacha20_xor_blocks", [
    build.VOIDP, build.VOIDP, build.U32, build.VOIDP, build.VOIDP,
    build.LONG, build.VOIDP])


def _pass(key, nonces, payload, B: int, n: int, mk_shape, ct_shape
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the cipher pass over B items of n payload words."""
    if B * (1 + (n + 15) // 16) > MAX_PASS_BLOCKS:
        raise ValueError(f"cipher pass of {B} x {n} words: more than "
                         f"{MAX_PASS_BLOCKS} blocks")
    dev = nonces.device
    mk = torch.empty(mk_shape, dtype=torch.int32, device=dev)
    ct = None if payload is None else torch.empty(ct_shape,
                                                  dtype=torch.int32,
                                                  device=dev)
    if B:
        src = None if payload is None else payload.data_ptr()
        vec = n % 4 == 0 and (src or 0) % 16 == 0
        PASS_KERNEL(key.data_ptr(), 8 if key.dim() == 2 else 0,
                    nonces.data_ptr(), src, int(vec),
                    None if ct is None else ct.data_ptr(), mk.data_ptr(),
                    B, n, build.stream_of(nonces))
    return mk, ct


def cipher_pass(key: torch.Tensor, nonces: torch.Tensor,
                payload: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The AEAD's cipher pass over B items in one launch -> (mac_keys (B,
    4) clamped below 2^31 - 1, ct (B, n); None without a payload).

    key: (8,) shared or (B, 8) per item; nonces: (B, 3); payload: (B, n)
    words, any n, or None for the MAC keys alone.  Item b's keystream
    runs over counters 0..ceil(n / 16): block 0 is its MAC-key block, the
    rest XOR onto its words (see :func:`.ref.cipher_pass_ref`)."""
    B = nonces.shape[0] if nonces.dim() == 2 else -1
    dev = nonces.device
    build.check_words("nonces", nonces, [(None, 3)], dev)
    build.check_words("key", key, [(8,), (B, 8)], dev)
    if payload is not None:
        build.check_words("payload", payload, [(B, None)], dev)
    if dev.type == "cpu":
        return cipher_pass_ref(key, nonces, payload)
    build.require_cuda(nonces)
    n = 0 if payload is None else payload.shape[1]
    return _pass(key, nonces, payload, B, n, (B, 4), (B, n))


def cipher_pass_message(key: torch.Tensor, nonce: torch.Tensor,
                        words: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The cipher pass of one message: key (8,), nonce (3,), words (n,)
    or None -> (mac_keys (4,), ct (n,) or None), one launch (the batched
    entry at B = 1)."""
    dev = nonce.device
    build.check_words("nonce", nonce, [(3,)], dev)
    build.check_words("key", key, [(8,)], dev)
    if words is not None:
        build.check_words("words", words, [(None,)], dev)
    if dev.type == "cpu":
        mk, ct = cipher_pass_ref(key, nonce.reshape(1, 3), None if words
                                 is None else words.reshape(1, -1))
        return mk[0], None if ct is None else ct[0]
    build.require_cuda(nonce)
    n = 0 if words is None else words.shape[0]
    return _pass(key, nonce, words, 1, n, (4,), (n,))


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
