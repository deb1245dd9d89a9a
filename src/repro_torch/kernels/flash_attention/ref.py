"""Plain torch version of the flash-attention forward kernel.

Replaces the reference's ``repro/kernels/flash_attention/ref.py`` as the
kernel's oracle, with one deliberate difference: the causal mask here is
**top-left** aligned (query row i sees keys 0..i), as the TPU kernel
``_flash_kernel`` masks (``q_pos = iq*q_chunk + iota``) and as the CUDA
kernel does.  The reference's ``ref.py`` masks with ``tril(k=Skv-Sq)``,
bottom-right aligned; the two agree only when Sq == Skv, which is the
only case the model (``models/layers.py::mha``) calls.  For Sq < Skv the
port is held to the reference's Pallas kernel, not to its ``ref.py``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D) -> (B, H, Sq, D) in q's type,
    and with ``return_lse`` the (B, H, Sq) f32 log-sum-exp of each row's
    scaled (and masked) scores, natural log.

    Scores, softmax and the product with V are f32.  The (H, Sq, Skv)
    scores are materialised one batch element at a time: at the serving
    path's shape (B=8, H=32, S=4096) all of them at once would take 17 GB,
    one element 2.1 GB."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        s = torch.matmul(q[b].float(), k[b].float().transpose(-1, -2))
        s /= math.sqrt(D)
        if causal:
            s.masked_fill_(~keep, NEG_INF)
        if return_lse:
            lse[b] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        del s
        out[b] = torch.matmul(p, v[b].float()).to(q.dtype)
    return (out, lse) if return_lse else out


#: the largest ||got - want|| / ||want|| of a row allowed to a bf16 result
BF16_ROW_RTOL = 1e-2


def bf16_mismatch(got: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> tuple:
    """How far a bf16 attention result ``got`` lies from ``want``, the
    exact attention of the same (B, H, S, D) inputs rounded to bf16
    -> (max_abs_err, excess, row_rel_err).  ``got`` passes when
    ``excess <= 0`` and ``row_rel_err <= BF16_ROW_RTOL``.

    ``excess`` is the largest |got - want| - (2^-7 |want| + 2^-8 P|V|)
    over the elements.  Each side rounds its output to bf16, at most
    2^-8 of its magnitude; rounding p to bf16 before PV (the tensor-core
    kernel does) moves each term p_j v_j by at most 2^-9 of p_j |v_j|,
    and P|V| = sum_j p_j |v_j| is this plain attention applied to |v|
    (twice that bound is allowed).  A fixed max-abs bound cannot tell a
    wrong kernel: a row that attends n keys of unit-variance values has
    magnitude ~sqrt(e/n), 0.026 at n = 4096, while the first rows are
    O(1).  ``row_rel_err`` is the largest relative L2 error of an output
    row; output rounding alone gives ~2^-9."""
    pv = attention_ref(q.float(), k.float(), v.float().abs(), causal=causal)
    want = want.float()
    diff = got.float() - want
    excess = (diff.abs() - 2 ** -7 * want.abs() - 2 ** -8 * pv).max().item()
    rows = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return diff.abs().max().item(), excess, rows.max().item()
