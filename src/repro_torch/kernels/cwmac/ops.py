"""Public ops: CW-MAC tags via the partials kernel + a torch fold.

Replaces the reference's ``repro/kernels/cwmac/ops.py``: ``mac_batch`` /
``mac2_batch`` (Pallas ``_mac_tile_batch_kernel``) and ``mac`` (Pallas
``_mac_tile_kernel``, one message), here :func:`mac` / :func:`mac2` with
both keys of ``mac2`` in one launch.  The kernels
(``repro_torch/csrc/cwmac.cu``) write one partial per (row, tile of
:data:`TILE_WORDS` words), each already scaled by its tile's absolute
power of r, so the host fold is a plain sum: ``tag = (sum_t P_t + s) mod
p`` in int64 on the device (the reference folds its unscaled partials by
Horner).  The tag is the value of one polynomial, so tile size,
padding and reduction order leave its bits unchanged.  A CPU tensor runs
the plain version (:mod:`.ref`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.crypto.cwmac import P31
from repro_torch.kernels import build
from repro_torch.kernels.cwmac.ref import (mac_partials_batch_ref,
                                           mac_partials_ref)

#: words per (row, tile) block: 4096 limbs, the reference's default tile
TILE_WORDS = 2048

KERNEL = build.Kernel("ss_cwmac_partials", [
    build.VOIDP, build.LONG, build.LONG, build.VOIDP, build.LONG,
    build.INT, build.VOIDP, build.INT, build.VOIDP])
MESSAGE_KERNEL = build.Kernel("ss_cwmac_mac_partials", [
    build.VOIDP, build.LONG, build.VOIDP, build.INT, build.INT,
    build.VOIDP, build.INT, build.VOIDP])


def mac_partials_batch(words: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(rows, T) scaled partials of (B, n) words under (rows,) keys; row q
    reads words row ``q % B`` (mac2 passes both keys as 2B rows)."""
    dev = words.device
    build.check_words("words", words, [(None, None)], dev)
    B, n = words.shape
    build.check_words("r", r, [(None,)], dev)
    rows = r.shape[0]
    if B == 0 or rows % B:
        raise ValueError(f"r has {rows} rows, not a multiple of B={B}")
    if dev.type == "cpu":
        return mac_partials_batch_ref(words, r, TILE_WORDS)
    build.require_cuda(words)
    T = -(-n // TILE_WORDS)
    out = torch.empty((rows, T), dtype=torch.int32, device=dev)
    if rows and T:
        KERNEL(words.data_ptr(), B, n, r.data_ptr(), rows, TILE_WORDS,
               out.data_ptr(), T, build.stream_of(words))
    return out


def mac_partials(words: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(K, T) scaled partials of ONE message of (n,) words under (K,)
    keys, K in {1, 2} (``mac2`` passes both keys)."""
    dev = words.device
    build.check_words("words", words, [(None,)], dev)
    build.check_words("r", r, [(1,), (2,)], dev)
    if dev.type == "cpu":
        return mac_partials_ref(words, r, TILE_WORDS)
    build.require_cuda(words)
    K, T = r.shape[0], -(-words.shape[0] // TILE_WORDS)
    out = torch.empty((K, T), dtype=torch.int32, device=dev)
    if T:
        MESSAGE_KERNEL(words.data_ptr(), words.shape[0], r.data_ptr(), K,
                       TILE_WORDS, out.data_ptr(), T, build.stream_of(words))
    return out


def _fold(partials: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return ((partials.to(torch.int64).sum(1) + s.to(torch.int64)) % P31) \
        .to(torch.int32)


def mac_batch(words: torch.Tensor, r: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """Row-wise MAC: (B, n) words under (B,) keys -> (B,) tags."""
    return _fold(mac_partials_batch(words, r.contiguous()), s)


def mac2_batch(words: torch.Tensor, r1: torch.Tensor, s1: torch.Tensor,
               r2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Row-wise dual-key MAC -> (B, 2) tags; both keys ride one launch."""
    B = words.shape[0]
    tags = _fold(mac_partials_batch(words, torch.cat([r1, r2])),
                 torch.cat([s1, s2]))
    return torch.stack([tags[:B], tags[B:]], dim=-1)


def mac(words: torch.Tensor, r: torch.Tensor, s: torch.Tensor
        ) -> torch.Tensor:
    """Single-message tag: (n,) words under scalar keys -> () int32."""
    return _fold(mac_partials(words, r.reshape(1)), s.reshape(1))[0]


def mac2(words: torch.Tensor, r1, s1, r2, s2) -> torch.Tensor:
    """Single-message dual-key tag -> (2,); both keys ride one launch."""
    return _fold(mac_partials(words, torch.stack([r1, r2]).reshape(2)),
                 torch.stack([s1, s2]).reshape(2))
