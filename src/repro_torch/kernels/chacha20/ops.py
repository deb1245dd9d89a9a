"""Public op: ChaCha20 keystream XOR over per-row (key, nonce, counter).

Replaces the reference's ``repro/kernels/chacha20/ops.py::xor_rows``
(Pallas ``_chacha_rows_kernel``).  A CPU tensor runs the plain torch
version (:mod:`.ref`); a CUDA tensor launches ``ss_chacha20_xor_rows``
(``repro_torch/csrc/chacha20.cu``) or raises.  The reference pads R to a
whole tile of 256 rows with zero cipher parameters and slices the tail
off; here the grid is rounded up instead and the kernel masks the rows
past R, so nothing is padded or copied.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chacha20.ref import chacha20_xor_rows_ref

KERNEL = build.Kernel("ss_chacha20_xor_rows", [
    build.VOIDP, build.INT, build.VOIDP, build.VOIDP, build.VOIDP,
    build.VOIDP, build.LONG, build.VOIDP])


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
