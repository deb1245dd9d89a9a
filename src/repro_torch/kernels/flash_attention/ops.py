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
is any of 1..:data:`MAX_HEAD_DIM`, as the reference's kernel takes any D:

* D <= :data:`TMA_HEAD_DIM` runs the TMA + ``wgmma`` kernel.  Where TMA
  cannot read the tensors as they are (a D whose rows are not 16-byte
  multiples: D not a multiple of 8 in bf16, of 4 in f32; a D stride
  other than 1; an unaligned base), the wrapper hands the kernel
  zero-padded copies at the next such width (:func:`_padded`) with the
  real D's softmax scale and slices the output's padded columns off; the
  zero columns add nothing to any score, so the lse is unchanged;
* 128 < D <= 256 runs the wide kernel of the same library (plain loads,
  any (b, s, h) strides; tensors with a D stride other than 1 are copied
  to contiguous ones first).

The plain version, which on the CPU takes any D, is never run for a CUDA
tensor.  ``return_lse=True`` also returns each query row's
log-sum-exp of its scaled scores (natural log, f32, (B, H, Sq)): the
residual the flash backward (:mod:`repro_torch.models.flash`) recomputes
the probabilities from.

On ``meta`` tensors both entries call one operator, ``torch.ops.
repro_torch.flash_attention_fwd``, so that a step traced on them (the dry
run, :mod:`repro_torch.launch.analysis`) passes through it: its fake
implementation makes outputs of the right shapes and launches nothing, and
its FLOP formula (:func:`flops`, registered with ``torch.utils.
flop_counter``) counts the kernel's work as ``chip_smoke.py``'s bounds do.
A CPU or CUDA tensor takes the same paths as before the operator existed.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

KERNEL = build.Kernel("ss_flash_attention_fwd", [
    build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP, build.VOIDP,
    build.INT,
    build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
    ctypes.c_float, build.VOIDP, build.VOIDP])
#: the element types the kernel takes (0 and 1 in its dtype argument)
DTYPES = (torch.bfloat16, torch.float32)
#: the largest head dim ``csrc/flash_attention.cu`` takes (any D from 1)
MAX_HEAD_DIM = 256
#: the largest head dim of its TMA + wgmma kernel, which computes a tile at
#: a padded width of 64 or 128 columns; above it the wide kernel runs
TMA_HEAD_DIM = 128


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one bf16 block of the kernel at
    ``head_dim``, bytes."""
    _check_head_dim(head_dim)
    return int(build.library().ss_flash_attention_smem_bytes(head_dim))


def _check_head_dim(D: int) -> None:
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head dim {D}; the kernel takes "
                         f"1 <= D <= {MAX_HEAD_DIM}")


def attended_pairs(B: int, H: int, Sq: int, Skv: int, causal: bool) -> int:
    """Attended (query, key) pairs: causal (top-left) row i attends
    min(i+1, Skv) keys; each costs one exp2 in the softmax."""
    if causal:
        full = min(Sq, Skv)
        pairs = full * (full + 1) // 2 + max(Sq - Skv, 0) * Skv
    else:
        pairs = Sq * Skv
    return B * H * pairs


def flops(B: int, H: int, Sq: int, Skv: int, D: int, causal: bool) -> int:
    """FLOPs the kernel needs: 2*D for q.k and 2*D for p*v per attended
    (query, key) pair, at the real D (not the padded width)."""
    return 4 * D * attended_pairs(B, H, Sq, Skv, causal)


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


def _tma_readable(t: torch.Tensor) -> bool:
    """TMA's rule: a unit D stride, a 16-byte aligned base and (batch,
    sequence, head) strides that are multiples of 16 bytes."""
    align = 16 // t.element_size()
    return t.stride(3) == 1 and not any(t.stride(i) % align
                                        for i in range(3)) \
        and t.data_ptr() % 16 == 0


def _launch(q, k, v, out, lse, causal: bool, seq: int, head: int,
            scale: float) -> None:
    build.require_cuda(q)
    D = q.shape[3]
    _check_head_dim(D)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1 or (D <= TMA_HEAD_DIM and not _tma_readable(t)):
            raise ValueError(
                f"flash attention kernel: {name} needs a unit D stride and, "
                f"at D <= {TMA_HEAD_DIM}, a 16-byte aligned base and (batch, "
                f"sequence, head) strides that are multiples of 16 bytes "
                f"(TMA's rule), got strides {t.stride()} at D = {D}")
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, seq, head)])
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(), DTYPES.index(q.dtype),
           q.shape[0], q.shape[head], q.shape[seq], k.shape[seq], D,
           int(causal), scale, ctypes.addressof(strides), build.stream_of(q))


def _lse_shape(q, seq: int, head: int, return_lse: bool):
    return (q.shape[0], q.shape[head], q.shape[seq]) if return_lse else (0,)


def padded_width(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The head dim of the zero-padded copies the card's kernel is handed
    where D <= :data:`TMA_HEAD_DIM` and TMA cannot read the tensors (or an
    output of their shape) as they are: D rounded up to a multiple of 16
    bytes' elements.  None where it reads them as they are."""
    D = q.shape[3]
    align = 16 // q.element_size()
    if D > TMA_HEAD_DIM or (D % align == 0 and all(
            _tma_readable(t) for t in (q, k, v))):
        return None
    return -(-D // align) * align


def _padded(fn, q, k, v, causal: bool, seq: int, head: int,
            return_lse: bool, width: int):
    """``fn`` (the kernel's or the plain forward, with a ``scale``) on
    contiguous copies of q, k and v zero-padded to ``width`` columns, at
    the real D's scale; the output's padded columns sliced off.  -> (out,
    lse)"""
    D = q.shape[3]

    def copy(t):
        buf = t.new_zeros((*t.shape[:3], width))
        buf[..., :D] = t
        return buf
    out, lse = fn(copy(q), copy(k), copy(v), causal, seq, head, return_lse,
                  scale=1.0 / math.sqrt(D))
    return out[..., :D].contiguous(), lse


def _plain(q, k, v, causal: bool, seq: int, head: int, return_lse: bool,
           scale=None):
    bhsd = (lambda t: t) if seq == 2 else (lambda t: t.transpose(1, 2))
    got = attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=causal,
                        return_lse=return_lse, scale=scale)
    if return_lse:
        return bhsd(got[0]), got[1]
    return bhsd(got), q.new_empty((0,), dtype=torch.float32)


def _kernel(q, k, v, causal: bool, seq: int, head: int, return_lse: bool,
            scale: float):
    if q.shape[3] > TMA_HEAD_DIM:           # the wide kernel: a unit D stride
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(_lse_shape(q, seq, head, return_lse),
                      dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, lse if return_lse else None, causal, seq=seq,
            head=head, scale=scale)
    return out, lse


def _forward(q, k, v, causal: bool, seq: int, head: int, return_lse: bool):
    """-> (out, lse): lse is (B, H, Sq) f32, or empty without
    ``return_lse``.  A CPU tensor runs the plain version, a CUDA tensor the
    kernel (on zero-padded copies where TMA needs them)."""
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, seq, head, return_lse)
    build.require_cuda(q)
    D = q.shape[3]
    _check_head_dim(D)
    width = padded_width(q, k, v)
    if width is not None:
        return _padded(_kernel, q, k, v, causal, seq, head, return_lse, width)
    return _kernel(q, k, v, causal, seq, head, return_lse,
                   scale=1.0 / math.sqrt(D))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         seq: int, head: int, return_lse: bool
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator, for a trace on meta tensors (its fake
    below); on a real tensor it is :func:`_forward`."""
    return _forward(q, k, v, causal, seq, head, return_lse)


@_fwd.register_fake
def _fwd_fake(q, k, v, causal, seq, head, return_lse):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(_lse_shape(q, seq, head, return_lse),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, seq, head, return_lse,
               *args, out_shape=None, **kwargs) -> int:
    return flops(q_shape[0], q_shape[head], q_shape[seq], k_shape[seq],
                 q_shape[3], causal)


def _run(q, k, v, causal: bool, return_lse: bool, seq: int, head: int):
    # a meta tensor goes through the operator (its fake and FLOP formula);
    # a CPU or CUDA tensor calls the plain version or the kernel directly,
    # with no dispatcher between the caller and the launch
    fwd = torch.ops.repro_torch.flash_attention_fwd \
        if q.device.type == "meta" else _forward
    out, lse = fwd(q, k, v, causal, seq, head, return_lse)
    return (out, lse) if return_lse else out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D) -> (B, H, Sq, D) in q's
    type (bf16 or f32), and with ``return_lse`` the (B, H, Sq) f32
    log-sum-exp.  Causal masking is top-left aligned (row i sees keys
    0..i), as the TPU kernel's."""
    _check(q, k, v, seq=2, head=1)
    return _run(q, k, v, causal, return_lse, seq=2, head=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Skv, H, D) with KV already repeated to
    H heads -> (B, Sq, H, D), and with ``return_lse`` the (B, H, Sq) f32
    log-sum-exp (head-major, the layout the backward reads)."""
    _check(q, k, v, seq=1, head=2)
    return _run(q, k, v, causal, return_lse, seq=1, head=2)
