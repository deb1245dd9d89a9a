"""Chunked gated linear attention — the shared recurrence engine (port of
``repro/models/gla.py``).

Both Mamba2's SSD and xLSTM's mLSTM are instances of the same per-head
recurrence over matrix state ``S`` (and optional normalizer ``n``)::

    S_t = exp(log_f_t) * S_{t-1} + i_t * k_t v_t^T        S: (Dk, Dv)
    n_t = exp(log_f_t) * n_{t-1} + i_t * k_t              n: (Dk,)
    y_t = q_t^T S_t            [ / max(|q_t^T n_t|, 1)    if normalized ]

The chunkwise-parallel form (chunk length Q) computes an intra-chunk
"attention" term with a decay mask plus an inter-chunk state carry:
O(S·Q) work and O(S) memory.  All state math is f32.  Plain torch, as the
reference computes it in jnp outside any Pallas kernel; the loop over
chunks is a Python loop (the reference's ``lax.scan``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_BIG = -1e30
_f32 = torch.float32


def chunked_gla(
    q: torch.Tensor,        # (B, S, H, Dk)
    k: torch.Tensor,        # (B, S, H, Dk)
    v: torch.Tensor,        # (B, S, H, Dv)
    log_f: torch.Tensor,    # (B, S, H)   per-step log decay (<= 0)
    i_gate: torch.Tensor,   # (B, S, H)   input gate (>= 0)
    *,
    chunk: int = 256,
    normalize: bool = False,
    init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = False,
):
    """Returns y: (B, S, H, Dv) f32 [and the final (S, n) state if
    requested]."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    dev = q.device

    if init_state is None:
        Sp = torch.zeros((B, H, Dk, Dv), dtype=_f32, device=dev)
        np_ = torch.zeros((B, H, Dk), dtype=_f32, device=dev)
    else:
        Sp, np_ = init_state

    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qf, kf, vf = (t[:, sl].to(_f32) for t in (q, k, v))   # (B,Q,H,*)
        fb = log_f[:, sl].to(_f32)
        ib = i_gate[:, sl].to(_f32)
        cum = torch.cumsum(fb, dim=1)            # (B,Q,H), non-increasing
        tot = cum[:, -1, :]                      # (B,H)

        # intra-chunk: A[t,s] = exp(cum_t - cum_s) * i_s * (q_t . k_s), s<=t
        scores = torch.einsum("bthd,bshd->bhts", qf, kf)
        decay = cum[:, :, None, :] - cum[:, None, :, :]        # (B,t,s,H)
        decay = torch.where(tri[None, :, :, None], decay,
                            torch.full((), NEG_BIG, dtype=_f32, device=dev))
        gate = torch.exp(decay) * ib[:, None, :, :]            # (B,t,s,H)
        gate = gate.permute(0, 3, 1, 2)                        # (B,H,t,s)
        A = scores * gate
        y = torch.einsum("bhts,bshd->bthd", A, vf)

        # inter-chunk: contribution of the carried state
        qdec = qf * torch.exp(cum)[..., None]                  # (B,Q,H,Dk)
        y = y + torch.einsum("bthk,bhkv->bthv", qdec, Sp)

        if normalize:
            nk = torch.einsum("bhts,bshk->bthk", gate, kf)
            n_t = nk + torch.einsum("bth,bhk->bthk", torch.exp(cum), np_)
            denom = torch.abs(torch.einsum("bthk,bthk->bth", qf, n_t))
            y = y / torch.clamp_min(denom, 1.0)[..., None]

        # state carry to the next chunk
        kscale = (torch.exp(tot[:, None, :] - cum) * ib)[..., None]
        ks = kf * kscale
        Sp = torch.exp(tot)[:, :, None, None] * Sp + torch.einsum(
            "bshk,bshv->bhkv", ks, vf)
        np_ = torch.exp(tot)[..., None] * np_ + ks.sum(dim=1)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if return_state:
        return y, (Sp, np_)
    return y


def gla_decode_step(
    q: torch.Tensor,        # (B, H, Dk)
    k: torch.Tensor,
    v: torch.Tensor,        # (B, H, Dv)
    log_f: torch.Tensor,    # (B, H)
    i_gate: torch.Tensor,   # (B, H)
    state: Tuple[torch.Tensor, torch.Tensor],   # S: (B,H,Dk,Dv), n: (B,H,Dk)
    *,
    normalize: bool = False,
):
    """Single-token recurrent update; O(1) per token."""
    Sp, np_ = state
    f = torch.exp(log_f.to(_f32))[..., None]                   # (B,H,1)
    i = i_gate.to(_f32)[..., None]                             # (B,H,1)
    qf, kf, vf = (t.to(_f32) for t in (q, k, v))
    S_new = f[..., None] * Sp + (i * kf)[..., None] * vf[..., None, :]
    n_new = f * np_ + i * kf
    y = torch.einsum("bhk,bhkv->bhv", qf, S_new)
    if normalize:
        denom = torch.abs(torch.einsum("bhk,bhk->bh", qf, n_new))
        y = y / torch.clamp_min(denom, 1.0)[..., None]
    return y, (S_new, n_new)


def gla_reference(q, k, v, log_f, i_gate, *, normalize=False):
    """Pure per-step oracle (sequential recurrence) for chunked_gla."""
    B, S, H, Dk = q.shape
    state = (torch.zeros((B, H, Dk, v.shape[-1]), dtype=_f32,
                         device=q.device),
             torch.zeros((B, H, Dk), dtype=_f32, device=q.device))
    ys = []
    for t in range(S):
        y, state = gla_decode_step(q[:, t], k[:, t], v[:, t], log_f[:, t],
                                   i_gate[:, t], state, normalize=normalize)
        ys.append(y)
    return torch.stack(ys, dim=1)
