"""Public ops: the fused enclave step over a window's (B, n) words
(:func:`enclave_map_window`), over per-row cipher parameters
(:func:`enclave_map_rows`) or over one chunk's blocks under a shared key
pair and nonce (:func:`enclave_map`).

Replaces the reference's ``repro/kernels/enclave_map/ops.py``:
``enclave_map_window`` is the window engine's enclave hop, Pallas
``_enclave_rows_kernel`` with the operand glue the reference builds
around it (padded rows, per-row nonces, counters and keys, the slice
back), in one launch of ``ss_enclave_map_window`` that reads the
caller's words and per-item coordinates as they are;
``enclave_map_rows`` keeps the general per-row coordinates
(``ss_enclave_map_rows``, off every path); ``enclave_map`` is Pallas
``_enclave_kernel`` (``ss_enclave_map_blocks``).  A CPU tensor runs the
plain version (:mod:`.ref`, plaintext visible); a CUDA tensor launches
the kernel (``repro_torch/csrc/enclave_map.cu``), whose plaintext lives
only in registers, or raises.  Like the reference's wrappers each call
counts one ``device.dispatches`` (and ``device.dispatches.enclave_map``);
the kernels' own launches are counted on :data:`WINDOW_KERNEL`,
:data:`KERNEL` and :data:`BLOCKS_KERNEL`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.enclave_map.enclave_map import (  # noqa: F401
    OP_IDS, OPS, const_bits, const_int)
from repro_torch.kernels.enclave_map.ref import (enclave_apply_ref,
                                                 enclave_apply_rows_ref,
                                                 enclave_map_window_ref)
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.u32 import MASK

_DISPATCHES = _METRICS.counter("device.dispatches")
_DISP_MAP = _METRICS.counter("device.dispatches.enclave_map")

WINDOW_KERNEL = build.Kernel("ss_enclave_map_window", [
    build.INT, build.VOIDP, build.INT, build.VOIDP, build.INT,
    build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP, build.LONG,
    build.LONG, build.U32, build.INT, build.VOIDP])
#: the window kernel indexes its blocks in 31 bits, two threads a block
MAX_WINDOW_BLOCKS = 2 ** 30 - 1
KERNEL = build.Kernel("ss_enclave_map_rows", [
    build.INT, build.VOIDP, build.INT, build.VOIDP, build.INT,
    build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP,
    build.VOIDP, build.LONG, build.U32, build.INT, build.VOIDP])
BLOCKS_KERNEL = build.Kernel("ss_enclave_map_blocks", [
    build.INT, build.VOIDP, build.VOIDP, build.VOIDP, build.U32,
    build.VOIDP, build.VOIDP, build.LONG, build.U32, build.INT, build.VOIDP])


def _check_op(op: str) -> None:
    if op not in OP_IDS:
        raise ValueError(f"unknown enclave op {op!r}; registered: "
                         f"{sorted(OP_IDS)}")


def enclave_map(key_in, key_out, nonce, counter0, blocks, *, op,
                const=0.0):
    """Fused decrypt -> ``OPS[op]`` -> encrypt over (N, 16) ciphertext
    blocks under (``key_in``, ``nonce``, counter0 + i), re-encrypted under
    ``key_out`` at the same nonce and counter; keys (8,), nonce (3,),
    counters wrap mod 2^32.  The grid covers N rounded up to a block and
    the kernel masks the tail, so N need not be a multiple of anything.
    """
    _check_op(op)
    _DISPATCHES.inc()
    _DISP_MAP.inc()
    dev = blocks.device
    build.check_words("blocks", blocks, [(None, 16)], dev, align16=True)
    for what, t in (("key_in", key_in), ("key_out", key_out)):
        build.check_words(what, t, [(8,)], dev)
    build.check_words("nonce", nonce, [(3,)], dev)
    counter0 = int(counter0) & MASK
    if dev.type == "cpu":
        return enclave_apply_ref(key_in, key_out, nonce, counter0, blocks,
                                 op=op, const=const)
    build.require_cuda(blocks)
    ci = const_int(const) if op == "delay_filter_u32" else 0
    out = torch.empty_like(blocks)
    if blocks.shape[0]:
        BLOCKS_KERNEL(OP_IDS[op], key_in.data_ptr(), key_out.data_ptr(),
                      nonce.data_ptr(), counter0, blocks.data_ptr(),
                      out.data_ptr(), blocks.shape[0],
                      const_bits(const) & 0xFFFFFFFF, ci,
                      build.stream_of(blocks))
    return out


def enclave_map_rows(keys_in, keys_out, nonces, counters, rows, *, op,
                     const=0.0, nonces_out=None, counters_out=None):
    """Per-row fused decrypt -> ``OPS[op]`` -> encrypt over (R, 16) rows.

    keys_in/keys_out: (8,) shared or (R, 8) per-row (mixed-epoch windows
    carry per-row keys); nonces: (R, 3); counters: (R,).
    ``nonces_out``/``counters_out`` re-encrypt under separate outbound
    coordinates (a re-executed share must not re-spend the inbound ones
    on the outbound key).  The grid covers R rounded up to a block and
    the kernel masks the tail, so R need not be a multiple of anything.
    """
    _check_op(op)
    _DISPATCHES.inc()
    _DISP_MAP.inc()
    if nonces_out is None:
        nonces_out = nonces
    if counters_out is None:
        counters_out = counters
    R = rows.shape[0] if rows.dim() == 2 else -1
    dev = rows.device
    build.check_words("rows", rows, [(None, 16)], dev, align16=True)
    for what, t in (("keys_in", keys_in), ("keys_out", keys_out)):
        build.check_words(what, t, [(8,), (R, 8)], dev)
    for what, t in (("nonces", nonces), ("nonces_out", nonces_out)):
        build.check_words(what, t, [(R, 3)], dev)
    for what, t in (("counters", counters), ("counters_out", counters_out)):
        build.check_words(what, t, [(R,)], dev)
    if dev.type == "cpu":
        return enclave_apply_rows_ref(
            keys_in, keys_out, nonces, counters, rows, op=op, const=const,
            nonces_out=nonces_out, counters_out=counters_out)
    build.require_cuda(rows)
    ci = const_int(const) if op == "delay_filter_u32" else 0
    out = torch.empty_like(rows)
    if R:
        KERNEL(OP_IDS[op], keys_in.data_ptr(),
               8 if keys_in.dim() == 2 else 0, keys_out.data_ptr(),
               8 if keys_out.dim() == 2 else 0, nonces.data_ptr(),
               counters.data_ptr(), nonces_out.data_ptr(),
               counters_out.data_ptr(), rows.data_ptr(), out.data_ptr(), R,
               const_bits(const) & 0xFFFFFFFF, ci, build.stream_of(rows))
    return out


def enclave_map_window(keys_in, keys_out, nonces_in, words, *, op,
                       const=0.0, nonces_out=None):
    """The window engine's enclave hop in one launch: fused decrypt ->
    ``OPS[op]`` -> encrypt of B items of n ciphertext words -> (B, n).

    keys_in/keys_out: (8,) shared or (B, 8) per item (a mixed-epoch
    window); nonces_in: (B, 3); item b's block j runs at counter j + 1
    under item b's key and nonce on both sides, or under ``nonces_out``
    (B, 3) on the way out when given (a re-executed share re-seals under
    fresh coordinates).  Any n: a ragged tail decrypts as if padded with
    zero ciphertext, as :func:`.ref.enclave_map_window_ref` composes it.
    """
    _check_op(op)
    _DISPATCHES.inc()
    _DISP_MAP.inc()
    B = words.shape[0] if words.dim() == 2 else -1
    dev = words.device
    build.check_words("words", words, [(None, None)], dev)
    for what, t in (("keys_in", keys_in), ("keys_out", keys_out)):
        build.check_words(what, t, [(8,), (B, 8)], dev)
    build.check_words("nonces_in", nonces_in, [(B, 3)], dev)
    if nonces_out is not None:
        build.check_words("nonces_out", nonces_out, [(B, 3)], dev)
    if dev.type == "cpu":
        return enclave_map_window_ref(keys_in, keys_out, nonces_in, words,
                                      op=op, const=const,
                                      nonces_out=nonces_out)
    build.require_cuda(words)
    n = words.shape[1]
    if B * ((n + 15) // 16) > MAX_WINDOW_BLOCKS:
        raise ValueError(f"enclave window of {B} x {n} words: more than "
                         f"{MAX_WINDOW_BLOCKS} blocks")
    ci = const_int(const) if op == "delay_filter_u32" else 0
    out = torch.empty_like(words)
    if out.numel():
        WINDOW_KERNEL(OP_IDS[op], keys_in.data_ptr(),
                      8 if keys_in.dim() == 2 else 0, keys_out.data_ptr(),
                      8 if keys_out.dim() == 2 else 0, nonces_in.data_ptr(),
                      (nonces_in if nonces_out is None
                       else nonces_out).data_ptr(),
                      words.data_ptr(), out.data_ptr(), B, n,
                      const_bits(const) & 0xFFFFFFFF, ci,
                      build.stream_of(words))
    return out
