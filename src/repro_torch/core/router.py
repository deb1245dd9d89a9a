"""Router components: the paper's ZeroMQ push/pull brokers.

Port of the chunk-level policies of ``repro/core/router.py``.  A router
connects two stages.  Inbound it *fair-queues* (paper: Pull socket with
fair-queuing over anonymous upstream workers); outbound it dispatches to
downstream workers *round-robin* (Push socket):

* ``round_robin``  — chunk i of the stream goes to worker i mod W;
* ``fair_queue``   — merge W worker sub-streams, one chunk each in turn.

Both drive the per-chunk engine (:mod:`repro_torch.core.pipeline`).  The
reference's keyed shuffle and its cross-device forms are not ported: no
engine of the port calls them yet.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Sequence

Chunk = Any


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
