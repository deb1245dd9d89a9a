"""Public ops: causal flash attention in the model's (B, S, H, D) layout
(:func:`flash_attention`) and head-major (:func:`flash_attention_bhsd`).

Replaces the reference's ``repro/kernels/flash_attention/ops.py`` and the
Pallas ``_flash_kernel`` behind it.  A CPU tensor runs the plain torch
version (:func:`.ref.attention_ref`); a CUDA tensor launches
``ss_flash_attention_fwd`` (``repro_torch/csrc/flash_attention.cu``) or
raises.  The kernel reads q, k and v through tensor maps over their
(batch, sequence, head) strides (16-byte multiples, unit D stride), so
the (B, S, H, D) entry makes no transposed copy (the reference swaps
axes to (B, H, S, D) for its BlockSpecs), and rows past the end read as
zeros, so any S is taken (the reference needs S to be a multiple of its
chunk); its tiles are fixed, so there are no chunk arguments.  K and V
come already repeated to the H query heads.  On the card the head dim D
is one of :data:`HEAD_DIMS`: another D raises ``ValueError`` naming them
(it is not handed to the plain version, which on the CPU takes any D).  ``return_lse=True`` also
returns each query row's log-sum-exp of its scaled scores (natural log,
f32, (B, H, Sq)): the residual the flash backward
(:mod:`repro_torch.models.flash`) recomputes the probabilities from.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

KERNEL = build.Kernel("ss_flash_attention_fwd", [
    build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP,
    build.INT,
    build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
    ctypes.c_float, build.VOIDP, build.VOIDP])
#: the element types the kernel takes (0 and 1 in its dtype argument)
DTYPES = (torch.bfloat16, torch.float32)
#: the head dims ``csrc/flash_attention.cu`` instantiates: every head dim
#: of the configs (64, 112, 128) and of their smoke forms (16)
HEAD_DIMS = (16, 64, 112, 128)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one bf16 block of the kernel at
    ``head_dim``, bytes."""
    _check_head_dim(head_dim)
    return int(build.library().ss_flash_attention_smem_bytes(head_dim))


def _check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {D}; the kernel is "
                         f"built for {HEAD_DIMS}")


def _check(q, k, v, seq: int, head: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise ValueError(f"flash attention: {name} is {t.dtype}, "
                             f"expected one of {DTYPES}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    B, H, D = q.shape[0], q.shape[head], q.shape[3]
    if k.shape != v.shape or (k.shape[0], k.shape[head], k.shape[3]) != (
            B, H, D) or k.shape[seq] == 0:
        raise ValueError(f"flash attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")


def _launch(q, k, v, out, lse, causal: bool, seq: int, head: int) -> None:
    build.require_cuda(q)
    D = q.shape[3]
    _check_head_dim(D)
    align = 16 // q.element_size()           # tensor maps: 16-byte strides
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1 or any(t.stride(i) % align for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} needs a unit "
                             f"D stride and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, seq, head)])
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(), DTYPES.index(q.dtype), q.shape[0], q.shape[head], q.shape[seq],
           k.shape[seq], D, int(causal), 1.0 / math.sqrt(D),
           ctypes.addressof(strides), build.stream_of(q))


def _run(q, k, v, causal: bool, return_lse: bool, seq: int, head: int):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((q.shape[0], q.shape[head], q.shape[seq]),
                      dtype=torch.float32, device=q.device) \
        if return_lse else None
    _launch(q, k, v, out, lse, causal, seq=seq, head=head)
    return (out, lse) if return_lse else out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D) -> (B, H, Sq, D) in q's
    type (bf16 or f32), and with ``return_lse`` the (B, H, Sq) f32
    log-sum-exp.  Causal masking is top-left aligned (row i sees keys
    0..i), as the TPU kernel's."""
    _check(q, k, v, seq=2, head=1)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, return_lse=return_lse)
    return _run(q, k, v, causal, return_lse, seq=2, head=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Skv, H, D) with KV already repeated to
    H heads -> (B, Sq, H, D), and with ``return_lse`` the (B, H, Sq) f32
    log-sum-exp (head-major, the layout the backward reads)."""
    _check(q, k, v, seq=1, head=2)
    if q.device.type == "cpu":
        got = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            return_lse=return_lse)
        if return_lse:
            return got[0].transpose(1, 2), got[1]
        return got.transpose(1, 2)
    return _run(q, k, v, causal, return_lse, seq=1, head=2)
