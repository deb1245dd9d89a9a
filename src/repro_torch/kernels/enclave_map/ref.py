"""Plain torch versions of the enclave map kernels: decrypt, op,
re-encrypt — with plaintext as a visible intermediate (exactly the
'encrypted' mode of the paper's Fig. 6, vs. the kernel's 'enclave')."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.crypto.chacha20 import chacha20_block, chacha20_block_rows
from repro_torch.kernels.enclave_map.enclave_map import OPS
from repro_torch.u32 import narrow, repeat_rows


def enclave_apply_ref(key_in, key_out, nonce, counter0, blocks, *,
                      op="identity", const=0.0) -> torch.Tensor:
    """Shared-key decrypt -> op -> re-encrypt of (N, 16) blocks, block i
    at counter ``(counter0 + i) mod 2^32`` and the same nonce both ways."""
    counters = narrow(int(counter0) + torch.arange(
        blocks.shape[0], dtype=torch.int64, device=blocks.device))
    pt = blocks ^ chacha20_block(key_in, nonce, counters)
    return OPS[op](pt, const) ^ chacha20_block(key_out, nonce, counters)


def enclave_apply_rows_ref(keys_in, keys_out, nonces, counters, data_rows,
                           *, op="identity", const=0.0, nonces_out=None,
                           counters_out=None) -> torch.Tensor:
    """Per-row (key, nonce, counter) decrypt -> op -> re-encrypt under
    ``keys_out`` at (``nonces_out``, ``counters_out``) when given, else
    at the inbound coordinates."""
    pt = data_rows ^ chacha20_block_rows(keys_in, nonces, counters)
    y = OPS[op](pt, const)
    return y ^ chacha20_block_rows(
        keys_out, nonces if nonces_out is None else nonces_out,
        counters if counters_out is None else counters_out)


def enclave_map_window_ref(keys_in, keys_out, nonces_in, words, *,
                           op="identity", const=0.0,
                           nonces_out=None) -> torch.Tensor:
    """The window engine's enclave hop over (B, n) words as the reference
    composes it: item b's words zero-padded to whole blocks, block j at
    counter j + 1 under item b's key (keys (8,) shared or (B, 8)) and
    nonce, :func:`enclave_apply_rows_ref` over the expanded rows (out at
    ``nonces_out`` when given), sliced back to (B, n)."""
    B, n = words.shape
    nb = (n + 15) // 16
    rows = F.pad(words, (0, nb * 16 - n)).reshape(B * nb, 16)
    ctrs = torch.arange(1, nb + 1, dtype=torch.int32,
                        device=words.device).repeat(B)

    def per_row(t):
        return t if t is None or t.dim() == 1 else repeat_rows(t, nb)
    out = enclave_apply_rows_ref(
        per_row(keys_in), per_row(keys_out), per_row(nonces_in), ctrs, rows,
        op=op, const=const, nonces_out=per_row(nonces_out))
    return out.reshape(B, nb * 16)[:, :n].contiguous()
