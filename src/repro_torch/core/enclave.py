"""Enclave executor: runs operators under one of the paper's three modes.

Port of ``repro/core/enclave.py``.  Fig. 6 of the paper compares three
deployments; they map here to:

* ``plain``     — operator on cleartext words (baseline, unsafe);
* ``encrypted`` — AEAD open -> operator -> AEAD seal as separate device
  programs: ciphertext on the wire, but plaintext transits device memory
  during the operator (which runs as plain torch ops, outside any
  kernel, exactly as the reference runs it outside Pallas);
* ``enclave``   — the fused enclave map kernel: plaintext exists only in
  registers inside the kernel, device memory sees ciphertext end to
  end.  Operators come from the static registry (the paper's
  no-dynamic-linking constraint, §4).

Two units of device work.  The window engine moves a
:class:`SealedWindow` of chunks (``run_window`` / ``run_static_window``,
batched AEAD and the window enclave kernel); MAC verdicts are
**deferred**: the window entry points return a per-row device verdict
vector without a host sync, and the pipeline syncs once per window.
Windows straddling a ``rekey_every_n`` flip carry mixed epochs and use
per-row keys, so rows never cross keystreams.  The per-chunk oracle
engine moves one :class:`SealedChunk` at a time (:meth:`EnclaveExecutor.
run` / :meth:`EnclaveExecutor.run_static`, the scalar AEAD and the
shared-key enclave kernel) and syncs each verdict as it comes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.crypto import aead
from repro_torch.crypto.keys import current_epoch as _cur_epoch, \
    resolve_key as _key_at
from repro_torch.kernels.cwmac import ops as cwmac_ops
from repro_torch.kernels.enclave_map import ops as enclave_ops
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.u32 import host_to_device

# the per-chunk enclave hop MACs ciphertext outside the fused kernel, one
# mac2 each side; the reference counts those launches at the call sites
_DISPATCHES = _METRICS.counter("device.dispatches")
_DISP_CWMAC = _METRICS.counter("device.dispatches.cwmac.mac2")


@dataclass
class SealedChunk:
    """Fixed-shape ciphertext unit of the per-chunk engine."""
    blocks: torch.Tensor             # (N, 16) int32-carried ciphertext (or
                                     # plaintext words in plain mode)
    tag: Optional[torch.Tensor]      # (2,) CW-MAC tag or None
    counter: int                     # per-stream chunk counter -> nonce
    meta: Tuple                      # tensor framing (shape, dtype, pad)
    n_words: int                     # valid words before block padding
    epoch: int = 0                   # ingress key epoch: every edge seals
                                     # the chunk under ITS epoch (counters
                                     # are epoch-local)


def _words_to_blocks(words: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = words.shape[0]
    n_blocks = (n + 15) // 16
    return F.pad(words, (0, n_blocks * 16 - n)).reshape(n_blocks, 16), n


def _chunk_coords(key, epoch: int, counter: int, device
                  ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """(StageKey, key words, nonce words) of a chunk under ``key`` at
    ``epoch``, the words on ``device``."""
    k = _key_at(key, epoch)
    return (k, host_to_device(k.key, device),
            host_to_device(k.nonce(counter), device))


def seal_tensor(key, counter: int, x: torch.Tensor,
                epoch: Optional[int] = None) -> SealedChunk:
    """Seal under ``key`` at ``epoch`` (the handle's current epoch when
    None — ingress; executors pass the chunk's own epoch through)."""
    if epoch is None:
        epoch = _cur_epoch(key)
    words, meta = aead.tensor_to_words(x)
    _, k, nonce = _chunk_coords(key, epoch, counter, words.device)
    ct, tag = aead.seal(k, nonce, words)
    blocks, n = _words_to_blocks(ct)
    return SealedChunk(blocks=blocks, tag=tag, counter=counter, meta=meta,
                       n_words=n, epoch=epoch)


def open_tensor(key, chunk: SealedChunk
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tensor, ok () bool tensor, not synced)."""
    _, k, nonce = _chunk_coords(key, chunk.epoch, chunk.counter,
                                chunk.blocks.device)
    ct = chunk.blocks.reshape(-1)[:chunk.n_words]
    pt, ok = aead.open_(k, nonce, ct, chunk.tag)
    return aead.words_to_tensor(pt, chunk.meta), ok


def plain_chunk(counter: int, x: torch.Tensor) -> SealedChunk:
    words, meta = aead.tensor_to_words(x)
    blocks, n = _words_to_blocks(words)
    return SealedChunk(blocks=blocks, tag=None, counter=counter, meta=meta,
                       n_words=n)


def unplain_chunk(chunk: SealedChunk) -> torch.Tensor:
    return aead.words_to_tensor(chunk.blocks.reshape(-1)[:chunk.n_words],
                                chunk.meta)


@dataclass
class SealedWindow:
    """A batch of same-framing sealed chunks kept as ONE pair of device
    tensors — the streaming engine's unit of flow.  ``counters`` /
    ``epochs`` are host-side per-row metadata; a window straddling a
    rekey flip carries mixed ``epochs`` and is opened with per-row keys.
    """
    words: torch.Tensor              # (B, n_words) int32-carried payload
                                     # rows (ct, or plaintext in plain mode)
    tags: Optional[torch.Tensor]     # (B, 2) CW-MAC tags or None
    counters: List[int]              # per-row chunk counters -> nonces
    epochs: List[int]                # per-row ingress epochs
    meta: Tuple                      # shared tensor framing (shape, dtype, pad)
    n_words: int

    def __len__(self) -> int:
        return len(self.counters)

    def select(self, idxs: Sequence[int]) -> "SealedWindow":
        """Row-gather a sub-window (ONE device gather per tensor)."""
        idx = host_to_device(np.asarray(idxs, np.int64), self.words.device)
        return SealedWindow(
            words=self.words[idx],
            tags=None if self.tags is None else self.tags[idx],
            counters=[self.counters[i] for i in idxs],
            epochs=[self.epochs[i] for i in idxs],
            meta=self.meta, n_words=self.n_words)


def _blocks_batch(words: torch.Tensor) -> torch.Tensor:
    """(B, n_words) -> (B, n_blocks, 16) zero-padded block rows."""
    B, n = words.shape
    n_blocks = (n + 15) // 16
    return F.pad(words, (0, n_blocks * 16 - n)).reshape(B, n_blocks, 16)


def _window_cipher_params(key, win: SealedWindow
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, nonces) for a window under ``key`` at each row's ingress
    epoch.  Single-epoch windows (the steady state) share one (8,) key;
    mixed-epoch windows (a rekey flip mid-window) get per-row (B, 8)
    keys so no row is ever sealed/opened under another epoch's
    keystream."""
    dev = win.words.device
    if len(set(win.epochs)) == 1:
        k = _key_at(key, win.epochs[0])
        keys = k.key
        nonces = np.stack([k.nonce(c) for c in win.counters])
    else:
        ks = [_key_at(key, e) for e in win.epochs]
        keys = np.stack([k.key for k in ks])
        nonces = np.stack([k.nonce(c) for k, c in zip(ks, win.counters)])
    return host_to_device(keys, dev), host_to_device(nonces, dev)


def _reseal_coords(win: SealedWindow, reseal_as
                   ) -> Tuple[SealedWindow, List[int], List[int]]:
    """Resolve the OUTBOUND cipher coordinates of a window dispatch.

    ``reseal_as`` is ``None`` (steady state: re-seal under the rows'
    ingress coordinates) or ``(counters, epoch)`` — a freshly reserved
    contiguous counter block at one epoch (``EdgeHandle.reserve_window``)
    that a re-execution seals under instead, because the ingress
    coordinates were already spent on the outbound key.  Returns (a
    coordinate *view* window for ``_window_cipher_params``, out
    counters, out epochs)."""
    if reseal_as is None:
        return win, win.counters, win.epochs
    counters, epoch = reseal_as
    out_counters = [int(c) for c in counters]
    if len(out_counters) != len(win):
        raise ValueError(
            f"reseal_as carries {len(out_counters)} counters for a "
            f"{len(win)}-row window — a re-executed share must reserve "
            f"exactly one fresh counter per row")
    out_epochs = [int(epoch)] * len(win)
    view = replace(win, counters=out_counters, epochs=out_epochs)
    return view, out_counters, out_epochs


def seal_tensors_window(key, counters: Sequence[int],
                        xs: Sequence[torch.Tensor],
                        epoch: Optional[int] = None) -> SealedWindow:
    """Seal B same-shape tensors under ``key`` at one epoch with ONE
    ``aead.seal_many`` — the ingress window path; counters come from a
    directory-reserved block (``EdgeHandle.reserve_window``)."""
    if epoch is None:
        epoch = _cur_epoch(key)
    k = _key_at(key, epoch)
    words, meta = aead.tensor_to_words_batch(torch.stack(list(xs)))
    dev = words.device
    nonces = host_to_device(np.stack([k.nonce(c) for c in counters]), dev)
    ct, tags = aead.seal_many(host_to_device(k.key, dev), nonces,
                              words.contiguous())
    return SealedWindow(words=ct, tags=tags,
                        counters=[int(c) for c in counters],
                        epochs=[epoch] * ct.shape[0], meta=meta,
                        n_words=words.shape[1])


def plain_window(counters: Sequence[int],
                 xs: Sequence[torch.Tensor]) -> SealedWindow:
    """Frame B same-shape tensors as one cleartext window."""
    words, meta = aead.tensor_to_words_batch(torch.stack(list(xs)))
    return SealedWindow(words=words, tags=None,
                        counters=[int(c) for c in counters],
                        epochs=[0] * words.shape[0], meta=meta,
                        n_words=words.shape[1])


def egress_window(mode: str, key, win: SealedWindow
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched trusted-subscriber egress: -> ((B, *item) tensor batch,
    ok verdict vector or None in plain mode).  Verdicts stay on device."""
    if mode == "plain":
        return aead.words_to_tensor_batch(win.words, win.meta), None
    keys, nonces = _window_cipher_params(key, win)
    pt, ok = aead.open_many(keys, nonces, win.words, win.tags)
    return aead.words_to_tensor_batch(pt, win.meta), ok


def uniform_runs(items: Sequence, key: Callable[[Any], Any]):
    """Split a sequence into consecutive runs of identical ``key(item)``
    — each run is one batched program.  Yields (start_index, run)."""
    i = 0
    while i < len(items):
        j = i + 1
        sig = key(items[i])
        while j < len(items) and key(items[j]) == sig:
            j += 1
        yield i, list(items[i:j])
        i = j


def _apply_static_words(op: str, const: float,
                        words: torch.Tensor) -> torch.Tensor:
    """The static operator on raw payload words, (B, n_words) -> (B,
    n_words), applied ONCE across every block row of the window (plain
    torch ops on the device: the encrypted and plain modes' operator)."""
    B, n = words.shape
    blocks = _blocks_batch(words).reshape(-1, 16)
    out = enclave_ops.OPS[op](blocks, const)
    return out.reshape(B, -1)[:, :n]


def _apply_static_f32(op: str, const: float, x: torch.Tensor
                      ) -> torch.Tensor:
    """The static operator registry on a decoded tensor (plain torch)."""
    words, meta = aead.tensor_to_words(x)
    blocks, n = _words_to_blocks(words)
    out = enclave_ops.OPS[op](blocks, const)
    return aead.words_to_tensor(out.reshape(-1)[:n], meta)


def ingress(mode: str, key, counter: int, x: torch.Tensor) -> SealedChunk:
    """Bring a source tensor into the pipeline under the security mode."""
    if mode == "plain":
        return plain_chunk(counter, x)
    return seal_tensor(key, counter, x)


def egress(mode: str, key, chunk: SealedChunk
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Take a result out of the pipeline (trusted subscriber): -> (tensor,
    ok () bool tensor; always true in plain mode)."""
    if mode == "plain":
        return unplain_chunk(chunk), torch.tensor(True)
    return open_tensor(key, chunk)


class EnclaveExecutor:
    """Executes one stage's operator under the configured security mode.

    ``key_in``/``key_out`` are static :class:`StageKey`s or KeyDirectory
    edge handles; with handles the executor opens AND re-seals each row
    under the epoch it was ingressed in (chunk counters are epoch-local).
    """

    def __init__(self, mode: str, key_in, key_out):
        if mode not in ("plain", "encrypted", "enclave"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.key_in = key_in
        self.key_out = key_out
        self.errors = 0
        # the pipeline's worker pool stamps each executor with the run's
        # tracer and a per-worker track ("s2/w1"), so the window entry
        # points' open -> op -> seal spans land on that worker's lane;
        # they measure the host's enqueue, the device's time lands in the
        # pipeline's per-window sync span
        self.tracer = NULL_TRACER
        self.track = "enclave"

    # -- the per-chunk engine: one chunk, verdicts synced as they come ----

    def run(self, fn: Callable[[torch.Tensor], torch.Tensor],
            chunk: SealedChunk) -> Optional[SealedChunk]:
        """open -> ``fn`` -> seal one chunk; None when its MAC fails (one
        host sync for the verdict)."""
        if self.mode == "plain":
            return plain_chunk(chunk.counter, fn(unplain_chunk(chunk)))
        if self.mode == "encrypted":
            x, ok = open_tensor(self.key_in, chunk)
            if not bool(ok):
                self.errors += 1
                return None
            # re-seal under the CHUNK's epoch: counters are epoch-local
            return seal_tensor(self.key_out, chunk.counter, fn(x),
                               epoch=chunk.epoch)
        raise ValueError(
            "enclave mode only executes registered static operators "
            "(run_static); arbitrary closures cannot be attested — "
            "the paper's no-dynamic-linking rule.")

    def run_static(self, op: str, const: float,
                   chunk: SealedChunk) -> Optional[SealedChunk]:
        """A registered operator on one chunk.  plain/encrypted: through
        :meth:`run`.  enclave: MAC check of the ciphertext (mac-key
        derivation + one dual-key MAC, outside the enclave: ciphertext is
        public), one host sync for its verdict, the fused shared-key
        enclave kernel (decrypt -> op -> encrypt under the outbound key,
        same nonce, payload counters from 1), and a re-tag under the
        outbound key — plaintext stays in registers."""
        if self.mode in ("plain", "encrypted"):
            return self.run(lambda x: _apply_static_f32(op, const, x), chunk)
        dev = chunk.blocks.device
        _, kin, nonce = _chunk_coords(self.key_in, chunk.epoch,
                                      chunk.counter, dev)
        _, kout, nonce_out = _chunk_coords(self.key_out, chunk.epoch,
                                           chunk.counter, dev)
        ct_words = chunk.blocks.reshape(-1)[:chunk.n_words]
        r1, s1, r2, s2 = aead.derive_mac_keys(kin, nonce)
        _DISPATCHES.inc()
        _DISP_CWMAC.inc()
        ok = (cwmac_ops.mac2(ct_words, r1, s1, r2, s2) == chunk.tag).all()
        if not bool(ok):
            self.errors += 1
            return None
        out_blocks = enclave_ops.enclave_map(kin, kout, nonce, 1,
                                             chunk.blocks, op=op,
                                             const=const)
        ro1, so1, ro2, so2 = aead.derive_mac_keys(kout, nonce_out)
        _DISPATCHES.inc()
        _DISP_CWMAC.inc()
        tag = cwmac_ops.mac2(out_blocks.reshape(-1)[:chunk.n_words],
                             ro1, so1, ro2, so2)
        return SealedChunk(blocks=out_blocks, tag=tag, counter=chunk.counter,
                           meta=chunk.meta, n_words=chunk.n_words,
                           epoch=chunk.epoch)

    # -- the window engine: deferred verdicts -----------------------------

    def run_window(self, fn: Callable[[torch.Tensor], torch.Tensor],
                   win: SealedWindow, *, reseal_as=None
                   ) -> Tuple[SealedWindow, Optional[torch.Tensor]]:
        """``open_many`` -> ``fn`` per decoded row -> ``seal_many``.

        Returns (out window, ok): a candidate output for EVERY input row
        plus a per-row device verdict vector (None in plain mode) that
        is NOT synced — MAC-failed rows carry garbage and are dropped by
        the caller after its one-per-window host sync.
        ``reseal_as=(counters, epoch)`` seals the output under a freshly
        reserved counter block instead of the ingress coordinates."""
        if self.mode == "plain":
            xb = aead.words_to_tensor_batch(win.words, win.meta)
            yb = torch.stack([fn(xb[b]) for b in range(len(win))])
            words, meta = aead.tensor_to_words_batch(yb)
            return replace(win, words=words, meta=meta,
                           n_words=words.shape[1]), None
        if self.mode != "encrypted":
            raise ValueError(
                "enclave mode only executes registered static operators "
                "(run_static_window); arbitrary closures cannot be "
                "attested — the paper's no-dynamic-linking rule.")
        out_view, out_ctrs, out_epochs = _reseal_coords(win, reseal_as)
        tr, track, B = self.tracer, self.track, len(win)
        with tr.span("enclave.open", cat="dispatch", track=track, rows=B):
            keys_in, nonces_in = _window_cipher_params(self.key_in, win)
            pt, ok = aead.open_many(keys_in, nonces_in, win.words, win.tags)
        with tr.span("enclave.op", cat="dispatch", track=track, rows=B):
            xb = aead.words_to_tensor_batch(pt, win.meta)
            yb = torch.stack([fn(xb[b]) for b in range(B)])
            words, meta = aead.tensor_to_words_batch(yb)
        with tr.span("enclave.seal", cat="dispatch", track=track, rows=B):
            keys_out, nonces_out = _window_cipher_params(self.key_out,
                                                         out_view)
            ct, tags = aead.seal_many(keys_out, nonces_out,
                                      words.contiguous())
        return replace(win, words=ct, tags=tags, meta=meta,
                       n_words=words.shape[1], counters=out_ctrs,
                       epochs=out_epochs), ok

    def run_static_window(self, op: str, const: float, win: SealedWindow,
                          *, reseal_as=None
                          ) -> Tuple[SealedWindow, Optional[torch.Tensor]]:
        """The steady-state hot path: a handful of device programs per
        window regardless of B (deferred verdicts, see :meth:`run_window`).

        encrypted: ``open_many`` -> the op once across all block rows ->
        ``seal_many`` (2 dispatches).  enclave: batched ciphertext MAC
        check (mac-key derive + MAC) + one ``enclave_map_window`` launch
        over the window's (B, n) words (per-item keys when the window
        straddles a rekey flip) + re-tag under the outbound keys (5
        dispatches);
        plaintext stays in registers, also on the ``reseal_as`` path,
        where the kernel re-encrypts directly under the fresh
        coordinates."""
        if self.mode == "plain":
            return replace(win, words=_apply_static_words(
                op, const, win.words)), None
        out_view, out_ctrs, out_epochs = _reseal_coords(win, reseal_as)
        keys_in, nonces_in = _window_cipher_params(self.key_in, win)
        keys_out, nonces_out = _window_cipher_params(self.key_out, out_view)
        tr, track, B = self.tracer, self.track, len(win)
        if self.mode == "encrypted":
            with tr.span("enclave.open", cat="dispatch", track=track,
                         rows=B):
                pt, ok = aead.open_many(keys_in, nonces_in, win.words,
                                        win.tags)
            with tr.span("enclave.op", cat="dispatch", track=track, op=op,
                         rows=B):
                words = _apply_static_words(op, const, pt)
            with tr.span("enclave.seal", cat="dispatch", track=track,
                         rows=B):
                ct, tags = aead.seal_many(keys_out, nonces_out,
                                          words.contiguous())
            return replace(win, words=ct, tags=tags, counters=out_ctrs,
                           epochs=out_epochs), ok
        # enclave: the MAC check on ciphertext happens outside the enclave
        # (ciphertext is public data): one mac-key derivation + one MAC
        with tr.span("enclave.open", cat="dispatch", track=track, rows=B):
            mk_in = aead.derive_mac_keys_many(keys_in, nonces_in)
            ok = (aead.mac2_many(win.words, mk_in) == win.tags).all(dim=-1)
        # fused decrypt->op->encrypt over the window's words as they are,
        # one launch; each chunk's payload keystream starts at counter 1.
        # A re-execution re-encrypts under the FRESH nonces (the chunk
        # counter only enters through the nonce)
        with tr.span("enclave.op", cat="dispatch", track=track, op=op,
                     rows=B):
            out_words = enclave_ops.enclave_map_window(
                keys_in, keys_out, nonces_in, win.words, op=op, const=const,
                nonces_out=None if reseal_as is None else nonces_out)
        # re-tag under the outbound keys, batched
        with tr.span("enclave.seal", cat="dispatch", track=track, rows=B):
            mk_out = aead.derive_mac_keys_many(keys_out, nonces_out)
            tags_out = aead.mac2_many(out_words, mk_out)
        return replace(win, words=out_words, tags=tags_out,
                       counters=out_ctrs, epochs=out_epochs), ok
