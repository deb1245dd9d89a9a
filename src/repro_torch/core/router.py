"""Router components: the paper's ZeroMQ push/pull brokers.

Port of ``repro/core/router.py``.  A router connects two stages.  Inbound
it *fair-queues* (paper: Pull socket with fair-queuing over anonymous
upstream workers); outbound it dispatches to downstream workers
*round-robin* (Push socket).  The workers are the shards of a mesh axis,
so the policies become deterministic resharding schedules:

* ``round_robin``  — chunk i of the stream goes to worker i mod W;
* ``fair_queue``   — merge W worker sub-streams, one chunk each in turn;
* ``shuffle``      — all-to-all over a key (the map->reduce boundary);
* ``keyed``        — consistent routing by key hash (stateful reducers).

The chunk-level policies drive the per-chunk engine
(:mod:`repro_torch.core.pipeline`); the shuffle and keyed policies are
collectives of :mod:`repro_torch.dist.collectives` (``shuffle_sharded``,
``route_keyed_sharded``), optionally over sealed channels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

Chunk = Any


@dataclass(frozen=True)
class RouterPolicy:
    kind: str                     # round_robin | fair_queue | shuffle | keyed
    num_keys: int = 0


def round_robin(chunks: Iterable[Chunk], num_workers: int
                ) -> List[List[Chunk]]:
    """Outbound dispatch: chunk i -> worker i mod W (paper's Push socket)."""
    queues: List[List[Chunk]] = [[] for _ in range(num_workers)]
    for i, c in enumerate(chunks):
        queues[i % num_workers].append(c)
    return queues


def fair_queue(worker_streams: Sequence[Iterable[Chunk]]) -> Iterator[Chunk]:
    """Inbound merge: one chunk from each live worker in turn (Pull socket)."""
    iters = [iter(s) for s in worker_streams]
    live = list(range(len(iters)))
    while live:
        nxt = []
        for w in live:
            try:
                yield next(iters[w])
                nxt.append(w)
            except StopIteration:
                pass
        live = nxt


def _bucket(x: torch.Tensor, keys: torch.Tensor, num_keys: int,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`shuffle_by_key` over G independent groups at once: ``x``
    (G, n, ...), ``keys`` (G, n) in [0, num_keys), ``mask`` (G, n) ->
    ((G, num_keys, n, ...) buckets, (G, num_keys) int32 counts), group g's
    exactly what ``shuffle_by_key(x[g], keys[g], num_keys, mask[g])``
    gives.  One stable sort of the (group, key) pairs, two cumulative
    counts and one scatter, with no host sync."""
    G, n = keys.shape
    K, dev = num_keys, x.device
    gkey = keys.to(torch.int64) + \
        torch.arange(G, device=dev)[:, None] * K          # (G, n)
    gkey = gkey.reshape(-1)
    # the reference sorts with jnp.argsort, which is stable: a row's slot
    # in its bucket is its rank among its bucket's rows in input order, so
    # the sort must be stable too or the buckets' contents differ
    sk, order = torch.sort(gkey, stable=True)
    ones = torch.ones_like(sk)
    all_counts = torch.zeros(G * K, dtype=torch.int64,
                             device=dev).index_add_(0, sk, ones)
    starts = torch.cumsum(all_counts, 0) - all_counts
    # position within bucket: rank in sorted order minus the bucket's
    # start (every row takes a slot, masked rows included)
    slot = torch.arange(G * n, device=dev) - starts[sk]
    dest = sk * n + slot
    rows = x.reshape(G * n, *x.shape[2:])[order]
    if mask is None:
        counts = all_counts
    else:
        valid = mask.reshape(-1)[order]
        counts = torch.zeros(G * K, dtype=torch.int64, device=dev) \
            .index_add_(0, sk, valid.to(torch.int64))
        rows = torch.where(valid.reshape(-1, *([1] * (x.dim() - 2))),
                           rows, torch.zeros((), dtype=x.dtype, device=dev))
    flat = torch.zeros((G * K * n, *x.shape[2:]), dtype=x.dtype, device=dev)
    flat[dest] = rows
    return (flat.reshape(G, K, n, *x.shape[2:]),
            counts.to(torch.int32).reshape(G, K))


def shuffle_by_key(chunk: torch.Tensor, keys: torch.Tensor, num_keys: int,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group rows of a chunk by key (dense): returns (num_keys, cap, ...)
    buckets + per-bucket int32 counts (cap = rows of the chunk). The
    dataflow equivalent of a keyed shuffle.  ``keys`` lie in [0,
    num_keys); a masked-out row keeps its slot, zero-filled, and is not
    counted."""
    buckets, counts = _bucket(chunk[None], keys[None], num_keys,
                              None if mask is None else mask[None])
    return buckets[0], counts[0]


def shuffle_sharded(x: torch.Tensor, mesh, axis: str = "model",
                    *, key=None, step=None):
    """All-to-all shuffle across a mesh axis (router as collective).

    x: (W, W, ...) mailbox layout — x[i, j] is the sub-block worker i
    sends to worker j; returns the inbox view y[j, i] = x[i, j] (the
    ZeroMQ 'shuffler' as one all-to-all).  With ``key`` the blocks are
    AEAD-sealed so the wire carries only ciphertext (``step`` is then
    required for a raw key, unique per round), and the result is (y, ok)
    with per-block MAC verdicts — repro_torch.dist.collectives.
    """
    from repro_torch.dist import collectives

    if key is not None:
        return collectives.secure_exchange(x, mesh, axis, key=key, step=step)
    return collectives.exchange(x, mesh, axis)


def route_keyed_sharded(x: torch.Tensor, row_keys: torch.Tensor, mesh,
                        axis: str = "model", *, key=None, step=None):
    """The ``keyed`` policy on a mesh: consistent hash-routing of rows to
    worker shards, optionally over sealed channels (dist.collectives)."""
    from repro_torch.dist import collectives

    return collectives.keyed_route(x, row_keys, mesh, axis, key=key,
                                   step=step)
