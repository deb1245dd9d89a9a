"""AEAD-sealed tensor channels between workers.

Port of ``repro/core/secure_channel.py``.  The paper encrypts every
stream between workers (SSL + enclave re-keying).  For pipeline
parallelism the wire is the activation crossing a stage boundary:
``protect`` seals it under the edge key before the hand-off and
``unprotect`` opens it on the receiving stage.  Every seal and open is
one batched AEAD call (:func:`repro_torch.crypto.aead.seal_many` /
``open_many``: one cipher-pass launch and one CW-MAC launch on the card);
``protect_many`` / ``unprotect_many`` seal B same-shape tensors under B
edge keys in one call, the key going in as a (B, 8) block.

The port runs its workers on one device, so :func:`sealed_ppermute`
takes the axis's N shards stacked as ``(N, ...)`` where the reference
runs inside ``shard_map`` with one shard per device: one seal of the N
rows, one permuted copy of the packed ``ct || tag`` payload (the wire)
and one open.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.crypto import aead
from repro_torch.crypto.keys import StageKey, resolve_key as _as_stage_key
from repro_torch.u32 import host_to_device


def _keys_nonces(keys: Sequence[StageKey], steps: Sequence[int], device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 8) key words and (B, 3) nonces of B (key, step) items."""
    kb = np.stack([k.key for k in keys])
    nb = np.stack([k.nonce(s) for k, s in zip(keys, steps)])
    return host_to_device(kb, device), host_to_device(nb, device)


def protect(key, step: int, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Seal a tensor for the wire. Returns (ct_words, tag, meta)."""
    ct, tags, meta = protect_many([key], [step], x[None])
    return ct[0], tags[0], meta


def unprotect(key, step: int, ct: torch.Tensor, tag: torch.Tensor,
              meta: Tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """Open a sealed tensor. Returns (tensor, ok) with ``ok`` a () bool
    tensor on the words' device (not synced)."""
    xs, ok = unprotect_many([key], [step], ct[None], tag[None], meta)
    return xs[0], ok[0]


def protect_many(keys: Sequence, steps: Sequence[int], xs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Seal B same-shape tensors under B edge keys in ONE batched call.

    ``xs``: (B, *item) stacked activations; ``keys``/``steps``: length B.
    Returns (ct (B, n_words), tags (B, 2), meta) with ``meta`` shared by
    every item (same shape/dtype framing)."""
    keys = [_as_stage_key(k) for k in keys]
    words, meta = aead.tensor_to_words_batch(xs)
    kb, nb = _keys_nonces(keys, steps, words.device)
    ct, tags = aead.seal_many(kb, nb, words)
    return ct, tags, meta


def unprotect_many(keys: Sequence, steps: Sequence[int], cts: torch.Tensor,
                   tags: torch.Tensor, meta: Tuple
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Open B sealed tensors in ONE batched call -> ((B, *item), ok (B,))."""
    keys = [_as_stage_key(k) for k in keys]
    kb, nb = _keys_nonces(keys, steps, cts.device)
    pt, ok = aead.open_many(kb, nb, cts, tags)
    return aead.words_to_tensor_batch(pt, meta), ok


class SecureChannel:
    """A sealed channel bound to one KeyDirectory edge.

    The channel never holds raw key material: every ``protect`` resolves
    the edge's *current-epoch* session key and allocates the next managed
    chunk counter from the directory (rotation resets it; the StageKey
    nonce guard backstops exhaustion).  ``unprotect`` takes the header
    ``(step, epoch)`` that ``protect`` returned, so chunks sealed before
    an epoch flip still open after it — the drain path.
    """

    def __init__(self, handle):
        self.handle = handle    # repro_torch.attest.directory.EdgeHandle

    def protect(self, x: torch.Tensor):
        """-> ((step, epoch) header, ct, tag, meta)."""
        step = self.handle.next_counter()
        epoch = self.handle.epoch
        ct, tag, meta = protect(self.handle.key(), step, x)
        return (step, epoch), ct, tag, meta

    def unprotect(self, header: Tuple[int, int], ct: torch.Tensor,
                  tag: torch.Tensor, meta: Tuple):
        step, epoch = header
        return unprotect(self.handle.key(epoch), step, ct, tag, meta)

    def protect_window(self, xs: torch.Tensor):
        """Seal a (B, *item) window in ONE batched call under ONE
        atomically reserved counter block (EdgeHandle.reserve_window):
        co-consumers of the edge can never land inside the block, and
        every row shares the window's epoch snapshot.

        -> ((base_step, epoch) header, ct (B, n_words), tags (B, 2), meta).
        """
        B = xs.shape[0]
        base, epoch = self.handle.reserve_window(B)
        k = self.handle.key(epoch)
        ct, tags, meta = protect_many([k] * B, range(base, base + B), xs)
        return (base, epoch), ct, tags, meta

    def unprotect_window(self, header: Tuple[int, int], cts: torch.Tensor,
                         tags: torch.Tensor, meta: Tuple):
        """Open a sealed window: -> ((B, *item), ok (B,) verdicts).  The
        header pins (base_step, epoch), so windows sealed before an epoch
        flip still open after it — the drain path, batched."""
        base, epoch = header
        B = cts.shape[0]
        k = self.handle.key(epoch)
        return unprotect_many([k] * B, range(base, base + B), cts, tags,
                              meta)


def sealed_ppermute(key, step: int, xs: torch.Tensor, perm
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A collective permute of sealed activations over an axis of N
    workers on one device.

    ``xs``: (N, ...) with row i shard i's tensor; ``perm``: (src, dst)
    pairs.  Returns ``(ys (N, ...), ok (N,))``: ``ys[d]`` is what shard d
    opened and ``ok[d]`` its MAC verdict.  A shard that receives nothing
    gets a zero payload, as the reference's ``ppermute`` leaves it, and
    its verdict is False.

    Every shard seals a *different* plaintext under the same (key, step),
    so the sender's shard index is mixed into nonce word 0 — otherwise all
    shards would share one ChaCha20 keystream and XORing two wire
    ciphertexts would leak ``x_i ^ x_j`` (a two-time pad).  The receiver
    re-derives the sender's index from the static ``perm``.
    """
    key = _as_stage_key(key)
    N = xs.shape[0]
    words, meta = aead.tensor_to_words_batch(xs)
    n_words, dev = words.shape[1], words.device
    kw = host_to_device(key.key, dev)
    base = key.nonce(step)
    sealed = np.tile(base, (N, 1))
    sealed[:, 0] = np.arange(N)
    # src_for[dst] = src for each (src, dst) in perm; shards that receive
    # nothing get themselves, and shards past the largest index perm
    # names take its last entry (the reference's clamped lookup)
    n = max((max(int(s), int(d)) for s, d in perm), default=0) + 1
    src_for = np.arange(n)
    for s, d in perm:
        src_for[int(d)] = int(s)
    opened = np.tile(base, (N, 1))
    opened[:, 0] = src_for[np.minimum(np.arange(N), n - 1)]
    ct, tags = aead.seal_many(kw, host_to_device(sealed, dev), words)

    # the wire: one permuted copy of the packed payload
    payload = torch.cat([ct, tags], dim=-1)
    received = torch.zeros_like(payload)
    if perm:
        src = host_to_device(np.array([int(s) for s, _ in perm]), dev)
        dst = host_to_device(np.array([int(d) for _, d in perm]), dev)
        received.index_copy_(0, dst, payload.index_select(0, src))
    pt, ok = aead.open_many(kw, host_to_device(opened, dev),
                            received[:, :n_words], received[:, n_words:])
    return aead.words_to_tensor_batch(pt, meta), ok
