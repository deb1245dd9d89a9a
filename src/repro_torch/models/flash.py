"""Memory-linear causal attention with a flash-style backward (port of
``repro/models/flash.py``, the training path's attention).

The reference wraps a jnp online-softmax forward in a ``jax.custom_vjp``
that saves only ``(q, k, v, out, lse)`` and recomputes the score blocks
in the backward.  Here that is a :class:`torch.autograd.Function`:

* **forward**: on a CUDA tensor the flash-attention kernel
  (``ss_flash_attention_fwd``, :mod:`repro_torch.kernels.flash_attention.
  ops`, kernel 7) with its log-sum-exp output; on a CPU tensor the plain
  chunked forward of the reference's ``_flash_fwd_impl`` (the same online
  softmax over (q_chunk, kv_chunk) blocks, p rounded to the value type
  before P V).  No fallback: a CUDA tensor launches the kernel or raises.
* **backward**: the reference's ``_flash_bwd`` block recompute in plain
  torch (the reference computes it in jnp, outside any Pallas kernel):
  ``delta = sum(do * out)``, ``p = exp(s - lse)``, then dv, dp, ds, dk and
  dq in f32 over (q_chunk, kv_chunk) blocks, cast back to the input
  types.  Blocks wholly above the causal diagonal are skipped: there p is
  exactly 0, so they add exactly nothing.

The chunk contract is the reference's: each chunk is clamped to the
sequence, and the sequence must be a multiple of it (``ValueError``
where the reference asserts); the kernel's own tiles are fixed, so on
the card the chunks only check the shapes.  Tensors are (B, S, H, D)
with K and V already repeated to the H query heads; ``lse`` is
(B, H, Sq), the kernel's layout.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.obs import trace

NEG_INF = -1e30


def _chunks(Sq: int, Skv: int, q_chunk: int, kv_chunk: int
            ) -> Tuple[int, int]:
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % qc or Skv % kc:
        raise ValueError(f"flash attention: sequence lengths ({Sq}, {Skv}) "
                         f"must be multiples of the chunks ({qc}, {kc})")
    return qc, kc


def _masked(causal: bool, q0: int, qc: int, k0: int, kc: int) -> str:
    """How the causal mask meets a (q, kv) block: "none" (all kept),
    "all" (all masked: the block is skipped) or "some"."""
    if not causal or k0 + kc - 1 <= q0:
        return "none"
    return "all" if k0 > q0 + qc - 1 else "some"


def _block_mask(q0: int, qc: int, k0: int, kc: int, device) -> torch.Tensor:
    """(qc, kc) bool, True where key k0 + j lies after query q0 + i."""
    qpos = torch.arange(q0, q0 + qc, device=device)
    kpos = torch.arange(k0, k0 + kc, device=device)
    return kpos[None, :] > qpos[:, None]


def _scores(qq: torch.Tensor, kk: torch.Tensor, scale: float, causal: bool,
            q0: int, k0: int) -> torch.Tensor:
    """f32 scaled scores of a block, (B, H, qc, kc), NEG_INF where masked."""
    s = torch.matmul(qq, kk.transpose(-1, -2)) * scale
    if _masked(causal, q0, qq.shape[2], k0, kk.shape[2]) == "some":
        s = s.masked_fill(_block_mask(q0, qq.shape[2], k0, kk.shape[2],
                                      s.device), NEG_INF)
    return s


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, q_chunk: int, kv_chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_flash_fwd_impl`` in torch: -> (out (B, Sq, H, D)
    in q's type, lse (B, H, Sq) f32).  Differentiated by autograd it is
    also ``mha``'s ``"chunked"`` schedule (the reference's
    ``chunked_attention``)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qc, kc = _chunks(Sq, Skv, q_chunk, kv_chunk)
    scale = 1.0 / math.sqrt(D)
    qf = q.transpose(1, 2).float()                     # (B, H, Sq, D)
    kf = k.transpose(1, 2).float()
    vb = v.transpose(1, 2)
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, qc):
        qq = qf[:, :, q0:q0 + qc]
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, Skv, kc):
            if _masked(causal, q0, qc, k0, kc) == "all":
                break                  # and every later block: p == 0 there
            s = _scores(qq, kf[:, :, k0:k0 + kc], scale, causal, q0, k0)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).float(),
                              vb[:, :, k0:k0 + kc].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        l = l.clamp_min(1e-30)
        out[:, :, q0:q0 + qc] = (acc / l[..., None]).to(q.dtype)
        lse[:, :, q0:q0 + qc] = m + torch.log(l)
    return out.transpose(1, 2), lse


def flash_backward_plain(q, k, v, out, lse, do, causal: bool, q_chunk: int,
                         kv_chunk: int):
    """The reference's ``_flash_bwd``: -> (dq, dk, dv) in the inputs'
    types, (B, S, H, D).  Every product and sum is f32."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qc, kc = _chunks(Sq, Skv, q_chunk, kv_chunk)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (t.transpose(1, 2).float() for t in (q, k, v, do))
    delta = (dof * out.transpose(1, 2).float()).sum(dim=-1)    # (B, H, Sq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, Skv, kc):
        kk, vv = kf[:, :, k0:k0 + kc], vf[:, :, k0:k0 + kc]
        for q0 in range(0, Sq, qc):
            if _masked(causal, q0, qc, k0, kc) == "all":
                continue
            qq, doo = qf[:, :, q0:q0 + qc], dof[:, :, q0:q0 + qc]
            s = _scores(qq, kk, scale, causal, q0, k0)
            p = torch.exp(s - lse[:, :, q0:q0 + qc, None])
            dv[:, :, k0:k0 + kc] += torch.matmul(p.transpose(-1, -2), doo)
            dp = torch.matmul(doo, vv.transpose(-1, -2))
            ds = p * (dp - delta[:, :, q0:q0 + qc, None]) * scale
            dk[:, :, k0:k0 + kc] += torch.matmul(ds.transpose(-1, -2), qq)
            dq[:, :, q0:q0 + qc] += torch.matmul(ds, kk)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def flash_forward(q, k, v, causal: bool, q_chunk: int, kv_chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out, lse): kernel 7 on the card, the plain chunked forward on
    the CPU."""
    _chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, q_chunk, kv_chunk)
    return flash_ops.flash_attention(q, k, v, causal=causal, return_lse=True)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the reference's custom VJP.  The backward
    is the active tracer's span ``attn.bwd`` (:func:`repro_torch.obs.
    trace.span`), opened on autograd's thread."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk):
        out, lse = flash_forward(q, k, v, causal, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with trace.span("attn.bwd"):
            dq, dk, dv = flash_backward_plain(q, k, v, out, lse, do,
                                              *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q, k, v: (B, S, H, D) with KV already expanded to H heads."""
    return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)
