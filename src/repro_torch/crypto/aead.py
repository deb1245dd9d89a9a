"""AEAD over u32 words: ChaCha20-CTR + CW-MAC (encrypt-then-MAC).

Port of ``repro/crypto/aead.py``.  As in ChaCha20-Poly1305, the MAC keys
(r1, s1, r2, s2) of an item come from its keystream block 0 (counter 0)
and the payload is encrypted from counter 1.  Every cipher pass is ONE
launch of the cipher-pass kernel (``ss_chacha20_cipher_pass``, through
:mod:`repro_torch.kernels.chacha20.ops`), which reads the caller's key,
nonces and words as they are and writes the ciphertext in the words'
layout and the clamped MAC keys.  The scalar :func:`seal` /
:func:`open_` (the per-chunk oracle engine's and the serving front's)
are one cipher launch over counters 0..N of one message plus ONE
dual-key MAC launch; :func:`seal_many` / :func:`open_many` the same over
a whole (B, n_words) batch; :func:`derive_mac_keys` /
:func:`derive_mac_keys_many` the pass with no payload (block 0 alone).
No padded, zero, counter or per-row copy is built around the kernel,
where the reference builds them inside its one jitted program.

Backends:

The scalar functions always go through the kernel wrappers, which run
their plain versions for CPU tensors.  The batched path has two backends:

* ``"kernel"`` (default) — the hand-written CUDA kernels
  (:mod:`repro_torch.kernels.chacha20.ops`,
  :mod:`repro_torch.kernels.cwmac.ops`).  For CPU tensors those wrappers
  run their plain versions, so the default works on both devices.
* ``"torch"`` — the plain torch crypto (the cipher pass's plain version
  over :mod:`.chacha20`, and :mod:`.cwmac`) directly.  On CUDA tensors
  this is only ever used when a caller names it (the kernel-vs-plain
  comparisons).

Words are int32-carried (:mod:`repro_torch.u32`).  There is no compile
cache (PyTorch runs eagerly), so the reference's ``fastpath_stats`` has
no counterpart.  Each batched call counts one ``device.dispatches`` (plus
its ``device.dispatches.aead.*`` site), where the reference counts its
one compiled-program launch; the scalar calls count none, as in the
reference, whose scalar path runs eagerly outside any counted program.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.crypto import cwmac
from repro_torch.kernels.chacha20 import ops as chacha_ops
from repro_torch.kernels.chacha20.ref import cipher_pass_ref
from repro_torch.kernels.cwmac import ops as cwmac_ops
from repro_torch.obs.metrics import REGISTRY as _METRICS

BACKENDS = ("kernel", "torch")

_DISPATCHES = _METRICS.counter("device.dispatches")
_DISP_SEAL = _METRICS.counter("device.dispatches.aead.seal_many")
_DISP_OPEN = _METRICS.counter("device.dispatches.aead.open_many")
_DISP_MACKEYS = _METRICS.counter("device.dispatches.aead.mac_keys_many")
_DISP_MAC2 = _METRICS.counter("device.dispatches.aead.mac2_many")


def derive_mac_keys(key: torch.Tensor, nonce: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """(r1, s1, r2, s2) from keystream block 0, clamped below 2^31 - 1:
    key (8,), nonce (3,) -> four () int32 tensors.  One launch of the
    cipher pass with no payload (its MAC-key block alone)."""
    mk, _ = chacha_ops.cipher_pass_message(key, nonce)
    return mk[0], mk[1], mk[2], mk[3]


def _fused_stream(key, nonce, words) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mac keys (4,) clamped, words ^ payload keystream): MAC keys
    and ciphertext from ONE cipher launch over counters 0..N."""
    return chacha_ops.cipher_pass_message(key, nonce, words.contiguous())


def _check_message(key, nonce, words, what):
    for name, t, shape in (("words", words, None), ("nonce", nonce, (3,)),
                           ("key", key, (8,))):
        if t.dtype != torch.int32:
            raise ValueError(f"{what} expects int32-carried u32 {name}, "
                             f"got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"{what}: {name} on {t.device}, words on "
                             f"{words.device}")
        if t.dim() != 1 or shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what} expects {name} of shape "
                             f"{shape or '(n,)'}, got {tuple(t.shape)}")


def seal(key: torch.Tensor, nonce: torch.Tensor, plaintext: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ciphertext (n,), tag (2,)), all int32-carried."""
    _check_message(key, nonce, plaintext, "seal")
    mk, ct = _fused_stream(key, nonce, plaintext)
    return ct, cwmac_ops.mac2(ct, mk[0], mk[1], mk[2], mk[3])


def open_(key: torch.Tensor, nonce: torch.Tensor, ciphertext: torch.Tensor,
          tag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (plaintext, ok: () bool tensor on the words' device).  The
    verdict is not synced: the caller decides what to do with ok=False
    (the stream layer drops the chunk)."""
    _check_message(key, nonce, ciphertext, "open_")
    ciphertext = ciphertext.contiguous()
    mk, pt = _fused_stream(key, nonce, ciphertext)
    expect = cwmac_ops.mac2(ciphertext, mk[0], mk[1], mk[2], mk[3])
    return pt, (expect == tag).all()


def _resolve_backend(backend: Optional[str]) -> str:
    backend = backend or "kernel"
    if backend not in BACKENDS:
        raise ValueError(f"unknown AEAD backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    return backend


def _cipher_pass(key, nonces, payload, backend):
    """-> (mac_keys (B, 4) clamped, payload ^ keystream (B, n); None
    without a payload): ONE cipher-pass launch on the kernel backend, its
    plain version on the torch backend."""
    if backend == "kernel":
        return chacha_ops.cipher_pass(key, nonces, payload)
    return cipher_pass_ref(key, nonces, payload)


def _mac2_batch(words, mk, backend):
    if backend == "kernel":
        return cwmac_ops.mac2_batch(words, mk[:, 0], mk[:, 1],
                                    mk[:, 2], mk[:, 3])
    return cwmac.mac2_batch(words, mk[:, 0], mk[:, 1], mk[:, 2], mk[:, 3])


def _check_batch(key, nonces, words, what):
    if words.dim() != 2:
        raise ValueError(f"{what} expects (B, n_words), "
                         f"got {tuple(words.shape)}")
    for name, t in (("words", words), ("nonces", nonces), ("key", key)):
        if t.dtype != torch.int32:
            raise ValueError(f"{what} expects int32-carried u32 {name} "
                             f"(view uint32 data as int32 first), "
                             f"got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"{what}: {name} on {t.device}, words on "
                             f"{words.device}")
    if tuple(nonces.shape) != (words.shape[0], 3):
        raise ValueError(f"{what} expects nonces (B, 3) matching B="
                         f"{words.shape[0]}, got {tuple(nonces.shape)}")
    if tuple(key.shape) not in ((8,), (words.shape[0], 8)):
        raise ValueError(f"{what} expects key (8,) or (B, 8), "
                         f"got {tuple(key.shape)}")


def seal_many(key: torch.Tensor, nonces: torch.Tensor, words: torch.Tensor,
              *, backend: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched AEAD seal of a (B, n_words) batch.

    ``key``: (8,) shared or (B, 8) per-item; ``nonces``: (B, 3);
    ``words``: (B, n_words); all int32-carried.  Returns (ct (B,
    n_words), tags (B, 2)), item-wise identical to the reference's
    ``seal``."""
    backend = _resolve_backend(backend)
    _check_batch(key, nonces, words, "seal_many")
    _DISPATCHES.inc()
    _DISP_SEAL.inc()
    mk, ct = _cipher_pass(key.contiguous(), nonces.contiguous(),
                          words.contiguous(), backend)
    return ct, _mac2_batch(ct, mk, backend)


def open_many(key: torch.Tensor, nonces: torch.Tensor, cts: torch.Tensor,
              tags: torch.Tensor, *, backend: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched AEAD open: -> (pt (B, n_words), ok (B,) bool verdicts).
    Verdicts stay on the device (no host sync)."""
    backend = _resolve_backend(backend)
    _check_batch(key, nonces, cts, "open_many")
    if tuple(tags.shape) != (cts.shape[0], 2):
        raise ValueError(f"open_many expects tags (B, 2), "
                         f"got {tuple(tags.shape)}")
    _DISPATCHES.inc()
    _DISP_OPEN.inc()
    cts = cts.contiguous()        # one copy of a strided view, not two
    mk, pt = _cipher_pass(key.contiguous(), nonces.contiguous(), cts,
                          backend)
    expect = _mac2_batch(cts, mk, backend)
    return pt, (expect == tags).all(dim=-1)


def derive_mac_keys_many(key: torch.Tensor, nonces: torch.Tensor, *,
                         backend: Optional[str] = None) -> torch.Tensor:
    """Batched MAC-key derivation: (B, 4) clamped (r1, s1, r2, s2) rows
    from keystream block 0 of each item.

    ``key``: (8,) shared or (B, 8) per-item; ``nonces``: (B, 3).  The
    kernel backend is one launch of the cipher pass with no payload, B
    blocks at counter 0 (the reference runs its jnp block function
    here)."""
    backend = _resolve_backend(backend)
    if nonces.dim() != 2 or nonces.shape[1] != 3:
        raise ValueError(f"derive_mac_keys_many expects nonces (B, 3), "
                         f"got {tuple(nonces.shape)}")
    _DISPATCHES.inc()
    _DISP_MACKEYS.inc()
    return _cipher_pass(key.contiguous(), nonces.contiguous(), None,
                        backend)[0]


def mac2_many(words: torch.Tensor, mac_keys: torch.Tensor, *,
              backend: Optional[str] = None) -> torch.Tensor:
    """Batched dual CW-MAC: (B, n_words) words under (B, 4) mac-key rows
    -> (B, 2) tags."""
    backend = _resolve_backend(backend)
    if words.dim() != 2 or tuple(mac_keys.shape) != (words.shape[0], 4):
        raise ValueError(f"mac2_many expects words (B, n) and mac_keys "
                         f"(B, 4); got {tuple(words.shape)} / "
                         f"{tuple(mac_keys.shape)}")
    _DISPATCHES.inc()
    _DISP_MAC2.inc()
    return _mac2_batch(words.contiguous(), mac_keys, backend)


# ---------------------------------------------------------------------------
# dtype framing helpers (tensors <-> u32 words)
# ---------------------------------------------------------------------------

# meta names are the reference's (numpy) dtype names; torch.int32 is the
# port's u32 word carrier, so it frames as "uint32" (and "int32" from the
# reference decodes to the same int32 tensor)
_DTYPES = {"uint32": torch.int32, "int32": torch.int32,
           "float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int64": torch.int64, "int16": torch.int16, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.int32:
        return "uint32"
    return str(dtype).replace("torch.", "")


def tensor_to_words_batch(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    """(B, *item) tensor batch -> ((B, n_words) int32-carried words, meta).

    Row b carries exactly the little-endian u32 words of ``x[b]``'s
    bytes, zero-padded to 4 bytes; meta is (item shape, dtype name, pad
    bytes), the reference's framing."""
    B = x.shape[0]
    item_shape = tuple(x.shape[1:])
    name = _dtype_name(x.dtype)
    if name == "uint32":
        return x.reshape(B, -1), (item_shape, "uint32", 0)
    raw = x.contiguous().reshape(B, -1).view(torch.uint8)
    pad = (-raw.shape[1]) % 4
    raw = F.pad(raw, (0, pad))
    return raw.view(torch.int32), (item_shape, name, pad)


def words_to_tensor_batch(words: torch.Tensor, meta: Tuple) -> torch.Tensor:
    """Inverse of :func:`tensor_to_words_batch`: (B, n_words) -> (B, *item)."""
    item_shape, dtype, pad = meta
    B = words.shape[0]
    tdt = _DTYPES[dtype]
    if tdt == torch.int32:
        return words.reshape((B,) + tuple(item_shape))
    raw = words.contiguous().view(torch.uint8).reshape(B, -1)
    if pad:
        raw = raw[:, :-pad]
    return raw.contiguous().view(tdt).reshape((B,) + tuple(item_shape))


def tensor_to_words(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    """Any tensor -> flat (n_words,) words + (shape, dtype, pad) meta."""
    words, (_, name, pad) = tensor_to_words_batch(x.reshape(1, -1))
    return words.reshape(-1), (tuple(x.shape), name, pad)


def words_to_tensor(words: torch.Tensor, meta: Tuple) -> torch.Tensor:
    """Inverse of :func:`tensor_to_words`."""
    shape, dtype, pad = meta
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    flat = words_to_tensor_batch(words.reshape(1, -1), ((n,), dtype, pad))
    return flat.reshape(shape)
