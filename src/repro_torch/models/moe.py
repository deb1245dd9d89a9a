"""Mixture-of-Experts FFN on one device (port of ``repro/models/moe.py``).

The reference shards its experts over the ``model`` mesh axis inside a
``shard_map``; this is that body at one expert shard (``mp = 1``): fixed
capacity, sort-based dispatch (no (T, X, C) one-hot dispatch tensor),
the experts' SwiGLU as batched products, and the top-k combine.  The
reference's combine ends in a ``psum`` over ``model`` in bf16; over one
shard that is the identity, but its bf16 rounding is not, so the combine
here rounds to bf16 too.  Plain torch: the reference's MoE runs no Pallas
kernel.

The port's own MoE (``ModelConfig.sigmoid_moe``: DeepSeek-V3's, as
Moonlight has it) has no counterpart in the reference: :func:`route_sigmoid`
chooses each token's top-k experts by sigmoid score plus a correction
bias and weighs them by the unbiased scores, renormalised and scaled;
:func:`moe_dropless` computes every assignment (no capacity) as grouped
products over each expert's contiguous segment of the sorted
assignments, its per-expert offsets left on the card (no host sync),
and adds the shared experts.  Spans ``moe.route``, ``moe.experts``,
``moe.shared``; the counter ``moe.routed_assignments`` (T·k a layer).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, Params, swiglu
from repro_torch.obs import trace
from repro_torch.obs.metrics import REGISTRY as _METRICS

#: routed (token, expert) assignments computed, T·k a dropless MoE layer
_ASSIGNMENTS = _METRICS.counter("moe.routed_assignments")


def moe_template(cfg) -> Dict[str, ParamSpec]:
    assert cfg.moe is not None
    d, X, Fe = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    sm = cfg.sigmoid_moe
    t = {
        "router": ParamSpec((d, X), ("embed", None), dtype="float32"),
        "wg": ParamSpec((X, d, Fe), ("experts", "embed", "moe_ff")),
        "wu": ParamSpec((X, d, Fe), ("experts", "embed", "moe_ff")),
        "wd": ParamSpec((X, Fe, d), ("experts", "moe_ff", "embed")),
    }
    if sm is not None:
        t["bias"] = ParamSpec((X,), (None,), init="zeros", dtype="float32")
        Fs = sm.num_shared_experts * Fe
        t["shared"] = {
            "wg": ParamSpec((d, Fs), ("embed", "mlp")),
            "wu": ParamSpec((d, Fs), ("embed", "mlp")),
            "wd": ParamSpec((Fs, d), ("mlp", "embed")),
        }
    return t


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


def route_sigmoid(router: torch.Tensor, bias: torch.Tensor,
                  xf: torch.Tensor, top_k: int, sm):
    """DeepSeek-V3's router in f32 (``scoring_func`` sigmoid, ``topk_method``
    noaux_tc over one group): (T, E) tokens -> (top-k weights (T, k) f32,
    top-k expert ids (T, k)).  The experts are chosen by score + ``bias``
    (ties to the lower id, as :func:`route`); the weights are the chosen
    unbiased scores, renormalised (``norm_topk_prob``, the denominator
    plus 1e-20 as DeepSeek's) and times ``routed_scale``."""
    scores = torch.sigmoid(xf.float() @ router)
    _, topi = torch.sort(scores + bias, dim=-1, descending=True, stable=True)
    topi = topi[:, :top_k]
    topw = scores.gather(1, topi)
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-20)
    return topw * sm.routed_scale, topi


def grouped_mm(a: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """(N, K) rows sorted by group, (G, K, M) weights and the (G,) int32
    end of each group's rows -> (N, M): each group's rows times its
    weight.  On the card one ``torch._grouped_mm`` reads the ends there;
    the plain version (the CPU's) a product per group."""
    if a.device.type != "cpu":
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty((a.shape[0], w.shape[2]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        out[start:end] = a[start:end] @ w[g]
        start = end
    return out


def moe_dropless(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """DeepSeek-V3's MoE FFN: x (B, S, E) -> (B, S, E) in x's type.

    The T·k assignments are sorted by expert (stably: within an expert in
    token order) and every one is computed: each expert's SwiGLU runs on
    its contiguous segment of the sorted rows (:func:`grouped_mm`, whose
    offsets are found on the card by a search of the sorted ids, so the
    layer never waits on the host).  The routing weight (f32) scales the
    expert's hidden activations in place before its down product, as
    ``silu(g) * u`` is formed in x's type (each product rounded once, as
    :func:`swiglu` rounds); each token's k outputs are gathered back in
    slot order and summed in f32, the shared experts' SwiGLU added, and
    the sum rounded once."""
    moe = cfg.moe
    Bl, S, E = x.shape
    T, X, k = Bl * S, moe.num_experts, moe.top_k
    xf = x.reshape(T, E)
    with trace.span("moe.route"):
        topw, topi = route_sigmoid(p["router"], p["bias"], xf, k,
                                   cfg.sigmoid_moe)
        flat = topi.reshape(-1)
        order = torch.argsort(flat, stable=True)
        ends = torch.searchsorted(flat[order], torch.arange(
            1, X + 1, dtype=flat.dtype, device=x.device)).to(torch.int32)
        rows = xf.index_select(0, order // k)
        s_w = topw.reshape(-1)[order]
    _ASSIGNMENTS.inc(T * k)
    with trace.span("moe.experts"):
        g = grouped_mm(rows, p["wg"], ends)
        u = grouped_mm(rows, p["wu"], ends)
        h = F.silu(g).mul_(u).mul_(s_w[:, None])
        del g, u
        o = grouped_mm(h, p["wd"], ends)
        back = torch.empty_like(order).scatter_(
            0, order, torch.arange(T * k, device=x.device))
        y = o[back].view(T, k, E).sum(dim=1, dtype=torch.float32)
    with trace.span("moe.shared"):
        sh = p["shared"]
        y = y + swiglu(xf, sh["wg"], sh["wu"], sh["wd"]).float()
    return y.to(x.dtype).reshape(Bl, S, E)


def moe_ffn(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (B, S, E) -> (out (B, S, E) in x's type, aux loss (0-d f32)).
    A dropless MoE (:func:`moe_dropless`) has no auxiliary loss here (its
    load balance is the correction bias, a training matter): 0."""
    moe = cfg.moe
    if cfg.sigmoid_moe is not None:
        return moe_dropless(p, x, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
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
    order, _, dest = dispatch(topi, X, C)
    # each token's row once per assignment, in the sorted order: a view
    # repeated k times, then a permutation (``xf[order // k]``, whose
    # backward would add a token's k gradients by atomics on the card, in
    # any order: here they are one sum over the repeat axis, and the
    # permutation's backward adds each element once)
    s_x = xf[:, None].expand(T, k, E).reshape(T * k, E)[order]
    s_w = topw.reshape(-1)[order]
    xbuf = torch.zeros((X * C + 1, E), dtype=x.dtype, device=x.device)
    xbuf = xbuf.index_add(0, dest, s_x)
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
    # index_add would add them by atomics on the card, in any order).  A
    # dropped assignment reads the zero row X*C: the gather's backward adds
    # into a kept row once (dest is unique there), so it is the same on
    # every run too
    oe = F.pad(oe, (0, 0, 0, 1))
    contrib = oe[dest].float() * s_w[:, None]
    by_token = torch.empty_like(contrib).index_copy_(0, order, contrib)
    by_token = by_token.view(T, k, E).gather(
        1, torch.argsort(topi, dim=-1)[..., None].expand(T, k, E))
    y = by_token[:, 0]
    for j in range(1, k):
        y = y + by_token[:, j]
    y = y.to(torch.bfloat16)
    return y.reshape(Bl, S, E).to(x.dtype), aux
