"""Mixture-of-Experts FFN on one device (port of ``repro/models/moe.py``).

The reference shards its experts over the ``model`` mesh axis inside a
``shard_map``; this is that body at one expert shard (``mp = 1``): fixed
capacity, sort-based dispatch (no (T, X, C) one-hot dispatch tensor),
the experts' SwiGLU as batched products, and the top-k combine.  The
reference's combine ends in a ``psum`` over ``model`` in bf16; over one
shard that is the identity, but its bf16 rounding is not, so the combine
here rounds to bf16 too.  Plain torch: the reference's MoE runs no Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, Params


def moe_template(cfg) -> Dict[str, ParamSpec]:
    assert cfg.moe is not None
    d, X, Fe = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    return {
        "router": ParamSpec((d, X), ("embed", None), dtype="float32"),
        "wg": ParamSpec((X, d, Fe), ("experts", "embed", "moe_ff")),
        "wu": ParamSpec((X, d, Fe), ("experts", "embed", "moe_ff")),
        "wd": ParamSpec((X, Fe, d), ("experts", "moe_ff", "embed")),
    }


def _capacity(tokens: int, top_k: int, num_experts: int, cf: float) -> int:
    c = int(math.ceil(tokens * top_k / num_experts * cf))
    return max(8, int(math.ceil(c / 8)) * 8)


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """The f32 router: (T, E) tokens -> (probs (T, X), top-k weights
    renormalised (T, k), top-k expert ids (T, k)).  Ties between equal
    probabilities go to the lower expert id, as ``jax.lax.top_k``."""
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    # torch.topk does not promise which of equal values comes first; a
    # stable descending sort does: the lower index
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :top_k], topi[:, :top_k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return probs, topw, topi


def dispatch(topi: torch.Tensor, X: int, C: int):
    """Sort-based dispatch of the (T, k) assignments into X experts of C
    slots: -> (order, keep, dest) over the T*k assignments sorted by
    expert (stably: within an expert, in token order).  ``dest`` is
    the row of the (X*C + 1, E) expert buffer, X*C (the trash row) for an
    assignment past its expert's capacity."""
    Tk = topi.numel()
    a_eid = topi.reshape(-1)
    order = torch.argsort(a_eid, stable=True)
    s_eid = a_eid[order]
    # each expert's first sorted assignment: a search of the sorted ids
    # (the same as cumsum(bincount) - bincount, and its output's size does
    # not hang on the data, so a meta trace takes it too)
    starts = torch.searchsorted(s_eid, torch.arange(X, dtype=s_eid.dtype,
                                                    device=s_eid.device))
    slot = torch.arange(Tk, device=topi.device) - starts[s_eid]
    keep = slot < C
    dest = torch.where(keep, s_eid * C + slot,
                       torch.full_like(slot, X * C))
    return order, keep, dest


def moe_ffn(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (B, S, E) -> (out (B, S, E) in x's type, aux loss (0-d f32))."""
    moe = cfg.moe
    Bl, S, E = x.shape
    T = Bl * S
    X, k = moe.num_experts, moe.top_k
    C = _capacity(T, k, X, moe.capacity_factor)

    xf = x.reshape(T, E)
    probs, topw, topi = route(p["router"], xf, k)

    # ---- load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                   # (X,)
    ce = torch.zeros((X,), dtype=torch.float32, device=x.device)
    ce = ce.index_add(0, topi.reshape(-1), torch.full(
        (T * k,), 1.0 / (T * k), dtype=torch.float32, device=x.device))
    aux = X * torch.sum(me * ce)

    # ---- dispatch
    order, keep, dest = dispatch(topi, X, C)
    s_tok = torch.div(order, k, rounding_mode="floor")       # a_tok[order]
    s_w = topw.reshape(-1)[order]
    xbuf = torch.zeros((X * C + 1, E), dtype=x.dtype, device=x.device)
    xbuf = xbuf.index_add(0, dest, xf[s_tok])
    xe = xbuf[:-1].reshape(X, C, E)

    # ---- expert SwiGLU (batched over experts)
    g = torch.bmm(xe, p["wg"])
    u = torch.bmm(xe, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    oe = torch.bmm(h, p["wd"]).reshape(X * C, E)

    # ---- combine: each assignment's expert output, weighted, summed per
    # token in f32, then rounded to bf16 (the reference's bf16 psum).  The
    # reference's segment_sum adds a token's k terms in the sorted
    # assignments' order (by expert id); the sum here keeps that order
    # and adds them one by one, so it is the same on every run (an
    # index_add would add them by atomics on the card, in any order)
    contrib = oe[torch.clamp_max(dest, X * C - 1)]
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    contrib = contrib.float() * s_w[:, None]
    by_token = torch.empty_like(contrib).index_copy_(0, order, contrib)
    by_token = by_token.view(T, k, E).gather(
        1, torch.argsort(topi, dim=-1)[..., None].expand(T, k, E))
    y = by_token[:, 0]
    for j in range(1, k):
        y = y + by_token[:, j]
    y = y.to(torch.bfloat16)
    return y.reshape(Bl, S, E).to(x.dtype), aux
