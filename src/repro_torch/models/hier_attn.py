"""Hierarchical causal attention: recursive halving (port of
``repro/models/hier_attn.py``, plain torch).

A causal attention over S positions decomposes as::

    [ A  0 ]   A = causal attention over the first half
    [ B  C ]   C = causal attention over the second half
               B = *dense* (unmasked) attention of the second-half queries
                   over the first-half keys.

Recursing log2(S/base) times, every block except the base-case diagonal
ones is dense; each rectangle runs the plain flash forward
(:func:`repro_torch.models.flash.flash_forward_plain`) and partial
results merge by log-sum-exp.  The reference's ``prefill`` uses this
schedule on the TPU; the port's ``prefill`` runs kernel 7 instead, whose
KV loop stops at the diagonal (``models/api.py`` says why), and keeps
this one as ``mha(attn_impl="hier")``.
"""
from __future__ import annotations

import torch

from repro_torch.models.flash import flash_forward_plain


def _merge(o1, lse1, o2, lse2):
    """Merge two partial attention results over the same queries.

    o_i: (B,S,H,D) normalized partial outputs; lse_i: (B,S,H) log-sum-exp.
    """
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)[..., None]
    w2 = torch.exp(lse2 - m)[..., None]
    o = (o1.float() * w1 + o2.float() * w2) / (w1 + w2)
    lse = m + torch.log(torch.exp(lse1 - m) + torch.exp(lse2 - m))
    return o.to(o1.dtype), lse


def hier_causal_attention(q, k, v, *, base: int = 1024, q_chunk: int = 512,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """q,k,v: (B,S,H,D), kv expanded to H heads. Returns (B,S,H,D)."""
    out, _ = _rec(q, k, v, base, q_chunk, kv_chunk)
    return out


def _fwd(q, k, v, causal, q_chunk, kv_chunk):
    """The plain flash forward with the reference's (B, S, H) lse."""
    out, lse = flash_forward_plain(q, k, v, causal, q_chunk, kv_chunk)
    return out, lse.transpose(1, 2)


def _rec(q, k, v, base, q_chunk, kv_chunk):
    S = q.shape[1]
    if S <= base:
        return _fwd(q, k, v, True, min(q_chunk, S), min(kv_chunk, S))
    half = S // 2
    o1, lse1 = _rec(q[:, :half], k[:, :half], v[:, :half], base, q_chunk,
                    kv_chunk)
    o2, lse2 = _rec(q[:, half:], k[:, half:], v[:, half:], base, q_chunk,
                    kv_chunk)
    # dense rectangle: second-half queries attend ALL first-half keys
    oc, lsec = _fwd(q[:, half:], k[:, :half], v[:, :half], False,
                    min(q_chunk, half), min(kv_chunk, half))
    o2m, _ = _merge(o2, lse2, oc, lsec)
    out = torch.cat([o1, o2m], dim=1)
    lse = torch.cat([lse1, torch.logaddexp(lse2, lsec)], dim=1)
    return out, lse
