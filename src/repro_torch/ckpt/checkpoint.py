"""Sealed checkpoints: encrypt-then-MAC at rest, async save, restore.

Port of ``repro/ckpt/checkpoint.py``, with the same on-disk format, so a
store written by either package opens in the other: one ``.npz`` of
flattened leaves (``params__leaf_i``; a bf16 leaf as its uint16 view,
``params__leaf_i__bf16``) plus a JSON manifest.  In ``sealed`` mode the
archive blob is cut into rows of 4,096 u32 words and the whole blob is
ChaCha20-encrypted and CW-MAC-tagged by ONE batched AEAD call
(:func:`repro_torch.crypto.aead.seal_many`: one cipher-pass launch and
the MAC launches on the card), under a per-store key (the seed's seal key
x a random salt) with the step mixed into each row's nonce counter — no
(key, nonce) pair recurs across checkpoints or stores.  ``restore``
verifies a keyed MAC over the whole tag list + length (truncation-proof)
and then every row's MAC verdict, raising on tamper.

Trees are nested dicts, lists and tuples of tensors (or numpy arrays),
flattened in ``jax.tree.flatten``'s order (dict keys sorted, ``None`` an
empty subtree), which is what makes the leaf numbering the reference's.
The port runs in one process on one device: ``restore(..., device=)``
places the leaves where the reference re-places them under
``shardings=``.  The sealed blob is built in memory, so the plaintext
archive never touches the disk (the reference writes it and removes it).
"""
from __future__ import annotations

import hashlib
import hmac
import io
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.crypto import aead
from repro_torch.crypto.keys import root_key_from_seed
from repro_torch.u32 import host_to_device

Params = Any

# Blob rows for the batched seal: 16 KiB of words each keeps B reasonable
# for multi-GB checkpoints while tiny test states stay a 1-row batch.
_ROW_WORDS = 4096
_SEAL_DOMAIN = 0x5EA1                 # nonce word 0: "seal" domain
_ROWS_PER_STEP = 1 << 20              # counter = step * 2^20 + row


# ------------------------------------------------------------- pytrees


def _leaves(tree: Params) -> List[Any]:
    """Leaves in ``jax.tree.flatten``'s order: dict keys sorted, lists and
    tuples in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _leaves(c)]
    return [tree]


def _treedef(tree: Params) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` spells
    it (the manifest's ``treedefs``; restore reads the template instead)."""
    def spell(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spell(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(spell(c) for c in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(spell(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({spell(tree)})"


def _unflatten(like: Params, leaves: List[Any]) -> Params:
    """``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)
    return build(like)


def _to_numpy(x) -> Tuple[np.ndarray, bool]:
    """A leaf on the host -> (array, was bf16): numpy has no bf16, so a
    bf16 leaf (a tensor, or ml_dtypes' numpy extension type) comes back
    as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16), True
        return x.cpu().numpy(), False
    a = np.asarray(x)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return a.view(np.uint16), True
    return a, False


def _flatten(tree: Params) -> Dict[str, np.ndarray]:
    out = {}
    for i, x in enumerate(_leaves(tree)):
        # numpy can't serialize bfloat16: store a u16 view; the member
        # name records the dtype and restore rebuilds it
        a, bf16 = _to_numpy(x)
        out[f"leaf_{i}__bf16" if bf16 else f"leaf_{i}"] = a
    return out


def _to_host(tree: Params) -> Params:
    """Every tensor of ``tree`` copied to host memory (same structure)."""
    return _unflatten(tree, [x.detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else np.array(x)
                             for x in _leaves(tree)])


# ------------------------------------------------------------- sealing


def _seal_key(seed: int) -> bytes:
    return hashlib.sha256(root_key_from_seed(seed) + b"|seal").digest()


def _blob_rows(data) -> Tuple[np.ndarray, int]:
    """bytes -> (B, _ROW_WORDS) int32-carried rows (zero-padded) + the
    original length."""
    n = len(data)
    n_rows = -(-n // (_ROW_WORDS * 4))
    rows = np.zeros((n_rows, _ROW_WORDS), np.int32)
    rows.reshape(-1).view(np.uint8)[:n] = np.frombuffer(data, np.uint8)
    return rows, n


def _row_nonces(n_rows: int, step: int) -> np.ndarray:
    """Per-row nonces: (0x5EA1 domain, step * 2^20 + row) — unique per
    (seal key, checkpoint step, row), so re-sealing a later step under
    the same seal key never reuses a keystream.  int32-carried."""
    if n_rows > _ROWS_PER_STEP:
        raise ValueError(f"checkpoint too large: {n_rows} rows > "
                         f"{_ROWS_PER_STEP} per step")
    c = np.uint64(step) * np.uint64(_ROWS_PER_STEP) + \
        np.arange(n_rows, dtype=np.uint64)
    return np.stack([np.full(n_rows, _SEAL_DOMAIN, np.uint32),
                     (c & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (c >> np.uint64(32)).astype(np.uint32)],
                    axis=-1).view(np.int32)


def _store_key(key32: bytes, salt: bytes) -> bytes:
    """Per-checkpoint seal key: the seed key mixed with a random salt, so
    two stores sealed under the same seed (and step) never share a
    ChaCha20 keystream."""
    return hashlib.sha256(key32 + b"|store|" + salt).digest()


def _tags_mac(key32: bytes, step: int, tags: bytes, n_bytes: int) -> str:
    """Keyed MAC binding the row-tag list, row count, and plaintext
    length — per-row CW-MACs alone would let an attacker truncate
    trailing rows (drop rows + their tags, shrink n_bytes) undetected."""
    body = b"ckpt-tags|%d|%d|" % (step, n_bytes) + tags
    return hmac.new(key32, body, hashlib.sha256).hexdigest()


def _sha256_beside(data):
    """The sha256 of ``data`` computed in a thread (hashlib releases the
    GIL on large buffers), beside the caller's seal, open or parse ->
    a function that waits for it and returns the hex digest."""
    out = []
    t = threading.Thread(
        target=lambda: out.append(hashlib.sha256(data).hexdigest()),
        daemon=True)
    t.start()

    def hexdigest() -> str:
        t.join()
        return out[0]
    return hexdigest


def _key_words(key32: bytes, device) -> torch.Tensor:
    return host_to_device(np.frombuffer(key32, dtype="<i4")[:8].copy(),
                          device)


def _seal_blob(key32: bytes, step: int, data, device
               ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """AEAD-seal a blob in one batched call on ``device``.

    Returns (ciphertext rows incl. padding, manifest metadata: row tags +
    salt + length + the tag-list MAC)."""
    salt = os.urandom(16)
    key32 = _store_key(key32, salt)
    rows, n = _blob_rows(data)
    nonces = host_to_device(_row_nonces(rows.shape[0], step), device)
    # the host rows go once they are on the device: a checkpoint's blob
    # is held at most twice in host memory
    rows = torch.from_numpy(rows).to(device)
    ct, tags = aead.seal_many(_key_words(key32, device), nonces, rows)
    del rows
    tags_b = tags.cpu().numpy().astype("<i4").tobytes()
    meta = {"tags": tags_b.hex(), "n_bytes": n, "salt": salt.hex(),
            "row_words": _ROW_WORDS, "nonce_step": step,
            "mac": _tags_mac(key32, step, tags_b, n)}
    return ct.cpu().numpy(), meta


def _open_blob(key32: bytes, a: Dict[str, Any], blob: np.ndarray,
               what: str, device) -> memoryview:
    """Open + verify a sealed blob (uint8 array) on ``device``; raises
    ValueError on any tamper.  -> the plaintext bytes."""
    step, n_bytes = a["nonce_step"], a["n_bytes"]
    key32 = _store_key(key32, bytes.fromhex(a["salt"]))
    tags_b = bytes.fromhex(a["tags"])
    if not hmac.compare_digest(a["mac"],
                               _tags_mac(key32, step, tags_b, n_bytes)):
        raise ValueError(
            f"checkpoint {what}: AEAD verification FAILED on the tag list "
            f"(rows dropped/reordered, length changed, or wrong seal key)")
    if len(blob) % (_ROW_WORDS * 4):
        raise ValueError(f"checkpoint {what}: sealed blob length "
                         f"{len(blob)} is not row-aligned (truncated?)")
    ct = blob.view("<i4").reshape(-1, _ROW_WORDS)
    tags = np.frombuffer(tags_b, dtype="<i4").reshape(-1, 2)
    if tags.shape[0] != ct.shape[0]:
        raise ValueError(f"checkpoint {what}: {tags.shape[0]} tags for "
                         f"{ct.shape[0]} rows")
    pt, ok = aead.open_many(
        _key_words(key32, device),
        host_to_device(_row_nonces(ct.shape[0], step), device),
        torch.from_numpy(ct).to(device),
        torch.from_numpy(tags.copy()).to(device))
    ok = ok.cpu().numpy()
    if not ok.all():
        bad = np.flatnonzero(~ok).tolist()
        raise ValueError(
            f"checkpoint {what}: AEAD verification FAILED on rows {bad} "
            f"(tampered or wrong seal key)")
    return memoryview(pt.cpu().numpy()).cast("B")[:n_bytes]


# ------------------------------------------------------------- the store


def save(path: str, step: int, params: Params, opt_state: Params,
         *, sealed: bool = True, seed: int = 0,
         extra: Optional[Dict[str, Any]] = None, device="cuda") -> str:
    """Write checkpoint atomically; returns the final directory path.
    ``device`` is where the seal runs (the leaves may be anywhere)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp-step-{step:08d}")
    final = os.path.join(path, f"step-{step:08d}")
    os.makedirs(tmp, exist_ok=True)

    payload, treedefs = {}, {}
    for name, tree in (("params", params), ("opt", opt_state)):
        payload.update({f"{name}__{k}": v
                        for k, v in _flatten(tree).items()})
        treedefs[name] = _treedef(tree)

    buf = io.BytesIO()
    np.savez(buf, **payload)
    del payload
    blob = buf.getbuffer()
    digest = _sha256_beside(blob)
    manifest = {
        "step": step,
        "sealed": sealed,
        "treedefs": treedefs,
        "extra": extra or {},
        "sha256_plain": None,
        "time": time.time(),
    }
    if sealed:
        ct, manifest["aead"] = _seal_blob(_seal_key(seed), step, blob,
                                          torch.device(device))
        ct.tofile(os.path.join(tmp, "arrays.sealed"))
    else:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            f.write(blob)
    manifest["sha256_plain"] = digest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_async(path: str, step: int, params: Params, opt_state: Params,
               **kw) -> threading.Thread:
    """Non-blocking save: every tensor is copied to the host before this
    returns (so the caller can go on mutating its buffers), the seal and
    the disk write run in a daemon thread."""
    params_h, opt_h = _to_host(params), _to_host(opt_state)
    t = threading.Thread(target=save, args=(path, step, params_h, opt_h),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(path)
             if d.startswith("step-")]
    return max(steps) if steps else None


def _leaf_tensor(arrays, key: str, device) -> torch.Tensor:
    if key in arrays:
        return torch.from_numpy(arrays[key]).to(device)
    # the u16 bits of a bf16 leaf, through int16 (no ml_dtypes needed)
    bits = arrays[f"{key}__bf16"].view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def restore(path: str, step: Optional[int] = None, *, seed: int = 0,
            params_like: Params = None, opt_like: Params = None,
            device="cuda"):
    """Load a checkpoint; verifies the seal. Returns (step, params, opt).

    params_like/opt_like give the tree structure (templates); every leaf
    comes back as a tensor on ``device``, where the open also runs."""
    device = torch.device(device)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["sealed"]:
        blob = np.fromfile(os.path.join(d, "arrays.sealed"), np.uint8)
        a = manifest.get("aead")
        if a is None:
            raise ValueError(
                f"checkpoint {d}: sealed with a pre-AEAD format "
                f"(manifest has {'poly1305' if 'poly1305' in manifest else 'no'}"
                f" seal metadata) — re-save it with the current code")
        if a.get("row_words", _ROW_WORDS) != _ROW_WORDS:
            raise ValueError(f"checkpoint {d}: unsupported row_words "
                             f"{a['row_words']}")
        plain = _open_blob(_seal_key(seed), a, blob, d, device)
        # the plaintext's digest (its MACs are verified already) runs
        # beside the parse; nothing is returned before it matches
        digest = _sha256_beside(plain)
        arrays = np.load(io.BytesIO(plain))
    else:
        digest = None
        arrays = np.load(os.path.join(d, "arrays.npz"))

    def rebuild(name, like):
        n = len(_leaves(like))
        return _unflatten(like, [_leaf_tensor(arrays, f"{name}__leaf_{i}",
                                              device) for i in range(n)])

    with arrays:
        out = step, rebuild("params", params_like), rebuild("opt", opt_like)
    if digest is not None and digest() != manifest["sha256_plain"]:
        raise ValueError(f"checkpoint {d}: plaintext hash mismatch")
    return out
