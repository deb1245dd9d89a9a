"""Secure sharded collectives: the ZeroMQ shuffler as encrypted all-to-all.

Port of ``repro/dist/collectives.py``.  The paper's map->reduce boundary
is a keyed shuffle over TLS links between workers.  The workers are the
W shards of a mesh axis and the shuffle is one all-to-all; the TLS link
becomes an AEAD seal applied *before* the exchange, so the wire only
ever carries ChaCha20 ciphertext and CW-MAC tags, and each destination
verifies every block it receives.  The port's W workers share one
device (:mod:`repro_torch.dist.meshctx`): the all-to-all is one permuted
copy of the mailbox on that device.

Layout convention ("mailbox"): a routed tensor has shape (W, W, ...) with
``x[i, j]`` the sub-block worker i sends to worker j; :func:`exchange`
returns the inbox view ``y[j, i] = x[i, j]``.  Nonces are derived from
``(step, src, dst)`` so no (key, nonce) pair is ever reused across shards
or rounds.  Words ride the port's int32 carrier (:mod:`repro_torch.u32`):
a 4-byte tensor becomes words by ``.view(torch.int32)`` where the
reference bit-casts to uint32.
"""
from __future__ import annotations

import contextlib
import functools
import math
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.crypto import aead
from repro_torch.crypto.keys import StageKey
from repro_torch.dist.meshctx import Mesh, check_on_mesh
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.u32 import MASK, host_to_device, lift

_NONCE_CACHE: "OrderedDict[Tuple[int, int, torch.device], torch.Tensor]" = \
    OrderedDict()
_NONCE_CACHE_MAX = 32


@functools.lru_cache(maxsize=8)
def _route_counter_base(W: int) -> np.ndarray:
    """(W*W,) uint64 ``src*W + dst`` grid — the step-independent part."""
    src, dst = np.meshgrid(np.arange(W, dtype=np.uint64),
                           np.arange(W, dtype=np.uint64), indexing="ij")
    # all-uint64 arithmetic: mixing np.uint64 scalars with Python ints
    # promotes to float64 under NumPy 1.x value-based casting
    return (src * np.uint64(W) + dst).reshape(-1)


def _route_nonces_base(W: int, base: int, device) -> torch.Tensor:
    """(W*W, 3) int32-carried nonces for counters ``base + src*W + dst``
    of one round, on ``device``.

    Each counter is unique per (key, base, src, dst) as long as the caller
    reserves the whole [base, base + W²) block — no nonce reuse across
    shards or rounds.  The host-side numpy grid is cached per W (and the
    device tensor per (W, base, device)), so repeated rounds pay no
    reconstruction cost."""
    ck = (W, int(base), torch.device(device))
    hit = _NONCE_CACHE.get(ck)
    if hit is not None:
        _NONCE_CACHE.move_to_end(ck)
        return hit
    c = np.uint64(base) + _route_counter_base(W)
    out = host_to_device(np.stack([np.zeros_like(c),
                                   c & np.uint64(0xFFFFFFFF),
                                   c >> np.uint64(32)], axis=-1)
                         .astype(np.uint32).view(np.int32), device)
    _NONCE_CACHE[ck] = out
    while len(_NONCE_CACHE) > _NONCE_CACHE_MAX:
        _NONCE_CACHE.popitem(last=False)
    return out


def _route_nonces(W: int, step: int, device) -> torch.Tensor:
    """Legacy step addressing: round ``step`` covers counters
    ``(step*W + src)*W + dst`` — i.e. base ``step * W²``."""
    return _route_nonces_base(W, step * W * W, device)


def _check_mailbox(x: torch.Tensor, W: int) -> None:
    if x.dim() < 2 or x.shape[0] != W or x.shape[1] != W:
        raise ValueError(
            f"mailbox layout requires shape (W, W, ...) with W={W}; "
            f"got {tuple(x.shape)}")


def _axis_size(mesh: Mesh, axis: str) -> int:
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes "
                         f"{mesh.axis_names})")
    return int(mesh.shape[axis])


_EXCHANGE_CALLS = _METRICS.counter("dist.exchange_calls")
# one exchange() == one collective; counted next to the per-site counter
_DISPATCHES = _METRICS.counter("device.dispatches")
_DISP_EXCHANGE = _METRICS.counter("device.dispatches.dist.exchange")


#: callables told of each collective, as (kind, bytes it moves between
#: workers): the dry run's analyzer (:mod:`repro_torch.launch.analysis`)
_OBSERVERS: list = []


@contextlib.contextmanager
def observe(fn):
    """Within the block, call ``fn(kind, nbytes)`` for every collective."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def exchange_call_count() -> int:
    """Total :func:`exchange` collectives issued (tests/benchmarks assert
    the sealed path costs exactly ONE collective per round).  Shim over
    the registered counter ``dist.exchange_calls``."""
    return int(_EXCHANGE_CALLS.value)


def exchange(x: torch.Tensor, mesh: Mesh, axis: str = "model", *,
             tracer=NULL_TRACER) -> torch.Tensor:
    """Plain all-to-all of mailbox blocks: ``y[j, i] = x[i, j]`` (one
    permuted copy on the mesh's device)."""
    _EXCHANGE_CALLS.inc()
    _DISPATCHES.inc()
    _DISP_EXCHANGE.inc()
    W = _axis_size(mesh, axis)
    _check_mailbox(x, W)
    check_on_mesh("exchange", x, mesh)
    for fn in _OBSERVERS:       # the off-diagonal blocks change workers
        fn("all-to-all", x.numel() * x.element_size() * (W - 1) // W)
    with tracer.span("dist.exchange", cat="dispatch", track="dist",
                     W=W, shape=str(tuple(x.shape))):
        return x.transpose(0, 1).contiguous()


def _resolve_session(key, step: Optional[int],
                     n_counters: int) -> Tuple[StageKey, int]:
    """Resolve (key, base counter) for a round that seals ``n_counters``
    blocks, from a raw StageKey or a KeyDirectory handle.

    With an ``EdgeHandle`` (repro_torch.attest.directory) the key is the
    edge's current-epoch session key and the WHOLE ``n_counters`` block is
    reserved from the directory's per-edge chunk counter — so other
    consumers of the same edge (e.g. ``SecureChannel.protect``) can never
    land inside this round's nonce range, and an epoch rotation resets
    the counter before exhaustion.  An explicit ``step`` is rejected for
    handles: it would bypass the managed counter and collide with a later
    managed allocation (a two-time pad).  A raw StageKey keeps the legacy
    contract: ``step`` is required, addresses a disjoint ``n_counters``-
    sized block per round, and uniqueness is the caller's burden.
    """
    if key is not None and not isinstance(key, StageKey):
        if step is not None:
            raise ValueError(
                "a KeyDirectory edge handle manages its own round "
                "counters; passing an explicit step would collide with a "
                "later managed allocation of the same value (nonce reuse)")
        return key.key(), key.next_counters(n_counters)
    if step is None:
        raise ValueError(
            "secure_exchange requires an explicit per-round step: reusing "
            "a (key, step) pair reuses the ChaCha20 keystream (pass a "
            "KeyDirectory edge handle to get managed counters)")
    return key, step * n_counters


def _words(x: torch.Tensor) -> torch.Tensor:
    """A 4-byte tensor's words: the same bits, viewed as the int32 carrier
    (the reference's ``bitcast_convert_type`` to uint32)."""
    return x if x.dtype == torch.int32 else x.view(torch.int32)


def secure_exchange(x: torch.Tensor, mesh: Mesh, axis: str = "model", *,
                    key, step: Optional[int] = None, tracer=NULL_TRACER
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AEAD-sealed all-to-all: ciphertext + tags cross the wire.

    ``key`` is a KeyDirectory edge handle (preferred — current-epoch
    session key + managed round counters) or a raw StageKey, in which
    case ``step`` is *required* and must be unique per (key, round) —
    reusing it reuses every (key, nonce) pair, i.e. a two-time pad.

    Each (src=i, dst=j) sub-block is sealed with counter
    ``(step*W + i)*W + j`` before the exchange and opened (MAC-checked)
    on the destination.  ``x`` must be a 4-byte dtype (words are a
    same-width view).  Returns ``(y, ok)`` with ``y[j, i]`` the opened
    block worker j received from i and ``ok[j, i]`` its MAC verdict (on
    the device, not synced).

    All W² blocks are sealed by ONE :func:`repro_torch.crypto.aead.
    seal_many` call, and the ciphertext + tags are packed into a single
    payload so each round issues exactly ONE :func:`exchange`."""
    W = _axis_size(mesh, axis)
    key, base = _resolve_session(key, step, W * W)
    _check_mailbox(x, W)
    check_on_mesh("secure_exchange", x, mesh)
    if x.element_size() != 4:
        raise ValueError(f"secure_exchange needs a 4-byte dtype, got "
                         f"{x.dtype}")
    blk_shape = tuple(x.shape[2:])
    n_words = math.prod(blk_shape) if blk_shape else 1
    kw = host_to_device(key.key, x.device)

    with tracer.span("dist.secure_exchange", cat="dispatch", track="dist",
                     W=W, n_words=n_words, base_counter=int(base)):
        words = _words(x.reshape(W * W, n_words))
        nonces = _route_nonces_base(W, base, x.device)   # (W*W, 3) [src, dst]
        ct, tags = aead.seal_many(kw, nonces, words)      # one batched call

        # pack ciphertext + tags into one payload: ONE exchange per round
        payload = torch.cat([ct, tags], dim=-1).reshape(W, W, n_words + 2)
        payload_r = exchange(payload, mesh, axis,
                             tracer=tracer).reshape(W * W, n_words + 2)

        # inbox[dst, src] was sealed with the (src, dst) counter
        nonces_in = nonces.reshape(W, W, 3).transpose(0, 1).reshape(W * W, 3)
        pt, ok = aead.open_many(kw, nonces_in, payload_r[:, :n_words],
                                payload_r[:, n_words:])
        out = pt if x.dtype == torch.int32 else pt.view(x.dtype)
        return out.reshape(W, W, *blk_shape), ok.reshape(W, W)


def _consistent_hash(k: torch.Tensor) -> torch.Tensor:
    """Cheap integer mix (Knuth multiplicative) for consistent routing,
    as u32 arithmetic -> int64 values in [0, 2^32).

    The int32 carrier would sign-extend on ``>>``: the product is lifted
    to int64 and masked to 32 bits before the shift, so the bits match
    the reference's uint32 ``k * 0x9E3779B1; k ^ (k >> 16)``."""
    k = (lift(k) * 0x9E3779B1) & MASK
    return k ^ (k >> 16)


def keyed_route(x: torch.Tensor, row_keys: torch.Tensor, mesh: Mesh,
                axis: str = "model", *, key=None,
                step: Optional[int] = None, hash_keys: bool = True):
    """The router's ``keyed`` policy as a sharded collective.

    ``x``: (W, n, ...) rows, worker i's at ``x[i]``; ``row_keys``: (W, n)
    integer keys.  Each worker buckets its rows by ``hash(key) % W``
    (dense, via :func:`repro_torch.core.router.shuffle_by_key`'s bucketing,
    all W workers in one batched pass) and the buckets cross through
    :func:`exchange` — or :func:`secure_exchange` when ``key`` is given (a
    KeyDirectory edge handle with managed counters, or a raw StageKey with
    ``step`` then required and unique per round), in which case the wire
    carries only ciphertext: the per-bucket row counts ride *inside* the
    sealed payload so even the key-distribution metadata stays hidden.

    Returns ``(inbox, counts, ok)``: ``inbox[j, i]`` = (cap, ...) bucket
    worker j received from i, ``counts[j, i]`` its valid-row count
    (int32), and ``ok`` the per-block MAC verdicts (all-true when
    unsealed)."""
    from repro_torch.core.router import _bucket  # lazy: router imports us

    W = _axis_size(mesh, axis)
    if x.shape[0] != W or tuple(row_keys.shape[:2]) != tuple(x.shape[:2]):
        raise ValueError(f"expected x (W={W}, n, ...) and matching keys; "
                         f"got {tuple(x.shape)} / {tuple(row_keys.shape)}")
    check_on_mesh("keyed_route", x, mesh)

    # worker-local bucketing, every worker at once (the reference vmaps
    # over the worker dim; only the exchange below is a collective)
    dest = _consistent_hash(row_keys) if hash_keys else lift(row_keys)
    mailbox, counts = _bucket(x, dest % W, W)     # (W,W,cap,...), (W,W)

    if key is None:
        inbox = exchange(mailbox, mesh, axis)
        counts_in = exchange(counts[..., None], mesh, axis)[..., 0]
        return inbox, counts_in, torch.ones((W, W), dtype=torch.bool,
                                            device=x.device)

    # sealed path: pack each bucket and its row count into ONE payload so
    # a single (key, step, src, dst) counter covers both — nothing about
    # the key distribution crosses the wire in cleartext.
    if x.element_size() != 4:
        raise ValueError(f"keyed_route needs a 4-byte dtype, got {x.dtype}")
    data_words = _words(mailbox.reshape(W, W, -1))
    payload = torch.cat([data_words, counts[..., None]], dim=-1)
    inbox_words, ok = secure_exchange(payload, mesh, axis, key=key,
                                      step=step)
    counts_in = inbox_words[..., -1]
    dw = inbox_words[..., :-1]
    inbox = (dw if x.dtype == torch.int32 else dw.view(x.dtype)
             ).reshape(mailbox.shape)
    return inbox, counts_in, ok
