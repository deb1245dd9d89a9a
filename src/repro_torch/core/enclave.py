"""Enclave executor: runs operators under one of the paper's three modes.

Port of the window paths of ``repro/core/enclave.py``.  Fig. 6 of the
paper compares three deployments; they map here to:

* ``plain``     — operator on cleartext words (baseline, unsafe);
* ``encrypted`` — ``open_many`` -> operator -> ``seal_many`` as separate
  device programs: ciphertext on the wire, but plaintext transits device
  memory during the operator (which runs as plain torch ops, outside
  any kernel, exactly as the reference runs it outside Pallas);
* ``enclave``   — the fused ``enclave_map_rows`` kernel: plaintext
  exists only in registers inside the kernel, device memory sees
  ciphertext end to end.  Operators come from the static registry (the
  paper's no-dynamic-linking constraint, §4).

The unit of device work is a :class:`SealedWindow` of chunks.  MAC
verdicts are **deferred**: the window entry points return a per-row
device verdict vector without a host sync; the pipeline syncs once per
window.  Windows straddling a ``rekey_every_n`` flip carry mixed epochs
and use per-row keys, so rows never cross keystreams.
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
from repro_torch.kernels.enclave_map import ops as enclave_ops
from repro_torch.u32 import host_to_device, repeat_rows


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
        keys_in, nonces_in = _window_cipher_params(self.key_in, win)
        pt, ok = aead.open_many(keys_in, nonces_in, win.words, win.tags)
        xb = aead.words_to_tensor_batch(pt, win.meta)
        yb = torch.stack([fn(xb[b]) for b in range(len(win))])
        words, meta = aead.tensor_to_words_batch(yb)
        keys_out, nonces_out = _window_cipher_params(self.key_out, out_view)
        ct, tags = aead.seal_many(keys_out, nonces_out, words.contiguous())
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
        check (mac-key derive + MAC) + one ``enclave_map_rows`` launch
        (per-row nonce/counter, per-row keys when the window straddles a
        rekey flip) + re-tag under the outbound keys (5 dispatches);
        plaintext stays in registers, also on the ``reseal_as`` path,
        where the kernel re-encrypts directly under the fresh
        coordinates."""
        if self.mode == "plain":
            return replace(win, words=_apply_static_words(
                op, const, win.words)), None
        out_view, out_ctrs, out_epochs = _reseal_coords(win, reseal_as)
        keys_in, nonces_in = _window_cipher_params(self.key_in, win)
        keys_out, nonces_out = _window_cipher_params(self.key_out, out_view)
        if self.mode == "encrypted":
            pt, ok = aead.open_many(keys_in, nonces_in, win.words, win.tags)
            words = _apply_static_words(op, const, pt)
            ct, tags = aead.seal_many(keys_out, nonces_out,
                                      words.contiguous())
            return replace(win, words=ct, tags=tags, counters=out_ctrs,
                           epochs=out_epochs), ok
        # enclave: the MAC check on ciphertext happens outside the enclave
        # (ciphertext is public data): one mac-key derivation + one MAC
        B, n_words = len(win), win.n_words
        n_blocks = (n_words + 15) // 16
        mk_in = aead.derive_mac_keys_many(keys_in, nonces_in)
        ok = (aead.mac2_many(win.words, mk_in) == win.tags).all(dim=-1)
        # fused decrypt->op->encrypt over the window's block rows; the
        # payload keystream of each chunk starts at counter 1
        rows = _blocks_batch(win.words).reshape(-1, 16)
        row_nonces = repeat_rows(nonces_in, n_blocks)
        row_ctrs = torch.arange(1, n_blocks + 1, dtype=torch.int32,
                                device=rows.device).repeat(B)
        row_kin = keys_in if keys_in.dim() == 1 \
            else repeat_rows(keys_in, n_blocks)
        row_kout = keys_out if keys_out.dim() == 1 \
            else repeat_rows(keys_out, n_blocks)
        kw = {}
        if reseal_as is not None:
            # re-encrypt under the FRESH coordinates (per-block keystream
            # counters stay 1..n_blocks: the chunk counter only enters
            # through the nonce)
            kw["nonces_out"] = repeat_rows(nonces_out, n_blocks)
        out_words = enclave_ops.enclave_map_rows(
            row_kin, row_kout, row_nonces, row_ctrs, rows, op=op,
            const=const, **kw).reshape(B, -1)[:, :n_words].contiguous()
        mk_out = aead.derive_mac_keys_many(keys_out, nonces_out)
        tags_out = aead.mac2_many(out_words, mk_out)
        return replace(win, words=out_words, tags=tags_out,
                       counters=out_ctrs, epochs=out_epochs), ok
