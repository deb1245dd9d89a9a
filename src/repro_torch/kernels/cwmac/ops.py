"""Public ops: CW-MAC tags, one kernel launch per call of up to 65,535 rows.

Replaces the reference's ``repro/kernels/cwmac/ops.py``: ``mac_batch`` /
``mac2_batch`` (Pallas ``_mac_tile_batch_kernel``) and ``mac`` (Pallas
``_mac_tile_kernel``, one message), here with ``mac2`` / ``mac2_batch``
taking both keys in the same launch.  The kernels
(``repro_torch/csrc/cwmac.cu``) write the finished ``(rows, K)`` tags with
s added: the fold across blocks happens on the card.  The keys go in as
they are held — strided columns of the ``(B, 4)`` mac-key rows, or the
scalar views of a ``(4,)`` key — with no copy.  A CPU tensor runs the
plain version (:mod:`.ref`) with the kernel's split of the row; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cwmac.ref import mac_tags_ref

#: threads per block and words per group (one 16-byte load)
THREADS, GROUP_WORDS = 256, 4
#: a row folds through one thread-block cluster of at most this many blocks
CLUSTER_BLOCKS = 8
#: groups per thread: at least MIN_GROUPS where the row allows, at most
#: CLUSTER_GROUPS on the cluster path (rows up to 131,072 words)
MIN_GROUPS, CLUSTER_GROUPS = 4, 16
#: SM count the CPU path plans for (an H100 SXM's)
H100_SMS = 132
#: rows one launch covers (they sit on gridDim.y, and the launcher refuses
#: more); :func:`mac2_batch` launches once per slab of this many rows
MAX_ROWS = 65535

KERNEL = build.Kernel("ss_cwmac_tags", [
    build.VOIDP, build.LONG, build.LONG, build.VOIDP, build.VOIDP,
    build.VOIDP, build.VOIDP, build.LONG, build.LONG, build.LONG, build.LONG,
    build.INT, build.INT, build.INT, build.INT, build.VOIDP, build.VOIDP,
    build.VOIDP, build.VOIDP])
MESSAGE_KERNEL = build.Kernel("ss_cwmac_mac_tags", [
    build.VOIDP, build.LONG, build.VOIDP, build.VOIDP, build.VOIDP,
    build.VOIDP, build.INT, build.INT, build.INT, build.INT, build.VOIDP,
    build.VOIDP, build.VOIDP, build.VOIDP])


@functools.lru_cache(maxsize=1024)
def plan(n: int, rows: int, sms: int = H100_SMS) -> Tuple[int, int, bool]:
    """How the kernel splits each of ``rows`` rows of ``n`` words ->
    (G blocks per row, m groups of 4 words per thread, cluster path).

    Rows up to CLUSTER_BLOCKS x CLUSTER_GROUPS x 1024 words fold through
    one cluster of G <= 8 blocks; longer rows take up to two blocks per SM
    over all rows and fold through tickets."""
    groups = max(1, -(-n // GROUP_WORDS))
    want = -(-groups // (THREADS * MIN_GROUPS))
    G = min(CLUSTER_BLOCKS, want)
    m = -(-groups // (G * THREADS))
    if m <= CLUSTER_GROUPS:
        return G, m, True
    G = min(want, max(1, 2 * sms // rows))
    m = -(-groups // (G * THREADS))
    return -(-groups // (m * THREADS)), m, False


def block_words(n: int, rows: int, sms: int = H100_SMS) -> int:
    """Words per block of :func:`plan`'s split (the plain version's)."""
    _, m, _ = plan(n, rows, sms)
    return m * THREADS * GROUP_WORDS


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: zeroed ticket arrays by (device index, stream handle): the ticket path
#: leaves them zero, and launches on one stream never overlap
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(dev: torch.device, stream: int, rows: int) -> torch.Tensor:
    t = _TICKETS.get((dev.index, stream))
    if t is None or t.numel() < rows:
        t = torch.zeros(max(rows, 64), dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def _check_keys(keys: List[torch.Tensor], shape, device) -> None:
    for t in keys:
        if t.dtype != torch.int32 or t.device != device \
                or tuple(t.shape) != shape:
            raise ValueError(f"cwmac keys: expected int32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _tags(words: torch.Tensor, keys: List[torch.Tensor], batched: bool
          ) -> torch.Tensor:
    """(B, n) words under K = len(keys) // 2 keys (r, s, r, s) -> (B, K)."""
    B, n = words.shape
    K = len(keys) // 2
    if words.device.type == "cpu":
        r = torch.stack(keys[0::2], dim=-1).reshape(B, K)
        s = torch.stack(keys[1::2], dim=-1).reshape(B, K)
        return mac_tags_ref(words, r, s, block_words(n, B))
    build.require_cuda(words)
    dev = words.device
    stream = build.stream_of(words)
    G, m, cluster = plan(n, B, _sms(dev.index))
    out = torch.empty((B, K), dtype=torch.int32, device=dev)
    # one launch a slab of at most MAX_ROWS rows (a sealed checkpoint's
    # ~151k rows are three); launches on one stream run in order, so every
    # slab reuses the same scratch and tickets
    slab = min(B, MAX_ROWS)
    scratch = tickets = None                 # the cluster path needs none
    if not cluster:
        part = torch.empty(slab * G * K, dtype=torch.int32, device=dev)
        scratch, tickets = part.data_ptr(), _tickets(dev, stream,
                                                     slab).data_ptr()
    r0, s0 = keys[0], keys[1]
    r1, s1 = (keys[2], keys[3]) if K == 2 else (r0, s0)
    if not batched:
        MESSAGE_KERNEL(words.data_ptr(), n, r0.data_ptr(), s0.data_ptr(),
                       r1.data_ptr(), s1.data_ptr(), K, G, m, int(cluster),
                       out.data_ptr(), scratch, tickets, stream)
        return out
    key_ptrs = [(k.data_ptr(), 4 * k.stride(0)) for k in (r0, s0, r1, s1)]
    for q0 in range(0, B, slab):
        KERNEL(words.data_ptr() + 4 * q0 * n, min(slab, B - q0), n,
               *[p + q0 * step for p, step in key_ptrs],
               r0.stride(0), s0.stride(0), r1.stride(0), s1.stride(0), K,
               G, m, int(cluster), out.data_ptr() + 4 * q0 * K, scratch,
               tickets, stream)
    return out


def _batch(words: torch.Tensor, keys: List[torch.Tensor]) -> torch.Tensor:
    build.check_words("words", words, [(None, None)], words.device)
    _check_keys(keys, (words.shape[0],), words.device)
    if words.shape[0] == 0:
        return torch.empty((0, len(keys) // 2), dtype=torch.int32,
                           device=words.device)
    return _tags(words, keys, batched=True)


def _message(words: torch.Tensor, keys: List[torch.Tensor]) -> torch.Tensor:
    build.check_words("words", words, [(None,)], words.device)
    keys = [k.reshape(()) for k in keys]
    _check_keys(keys, (), words.device)
    return _tags(words.reshape(1, -1), keys, batched=False)[0]


def mac_batch(words: torch.Tensor, r: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """Row-wise MAC: (B, n) words under (B,) keys -> (B,) tags."""
    return _batch(words, [r, s])[:, 0]


def mac2_batch(words: torch.Tensor, r1: torch.Tensor, s1: torch.Tensor,
               r2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Row-wise dual-key MAC -> (B, 2) tags in one launch; the keys may
    be strided columns (``mk[:, 0]`` .. ``mk[:, 3]`` of (B, 4) rows)."""
    return _batch(words, [r1, s1, r2, s2])


def mac(words: torch.Tensor, r: torch.Tensor, s: torch.Tensor
        ) -> torch.Tensor:
    """Single-message tag: (n,) words under scalar keys -> () int32."""
    return _message(words, [r, s])[0]


def mac2(words: torch.Tensor, r1, s1, r2, s2) -> torch.Tensor:
    """Single-message dual-key tag -> (2,) in one launch; the keys are
    () or (1,) views (``mk[0]`` .. ``mk[3]`` of a (4,) key)."""
    return _message(words, [r1, s1, r2, s2])
