"""A family module of the port's ``moe`` family, for the test that adds a
configuration of a new family with new files only: its weight layout,
its counts of the work, and its plain reference of the last logits in
float32 (no ``train``: the fixture has no training cell).

One layer: ``x + attn(rms_norm(x))``, then ``x + moe(rms_norm(x))``.
Attention is causal softmax attention over rotary positions (the
rotate-half form), the key/value heads shared by ``H / K`` query heads.
The MoE: an f32 router's softmax over the experts, the ``top_k`` largest
(ties to the lower expert) renormalised to sum to 1, and the sum of the
chosen experts' SwiGLU ``(silu(x Wg) * x Wu) Wd`` weighted by them; no
token is dropped.  Every product in float32 with TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F


def layout(m: dict) -> List[tuple]:
    """(path, shape, init, std[, type]) of every weight, in draw order;
    the router in float32, the rest bf16."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    hd = m["num_heads"] * m["head_dim"]
    kd = m["num_kv_heads"] * m["head_dim"]
    X, Fe = m["moe"]["num_experts"], m["moe"]["d_expert"]
    leaves = [
        (("embed",), (V, d), "normal", 0.02),
        (("final_norm",), (d,), "ones", 0.0),
        (("layers", "attn", "wk"), (L, d, kd), "normal", d ** -0.5),
        (("layers", "attn", "wo"), (L, hd, d), "normal", hd ** -0.5),
        (("layers", "attn", "wq"), (L, d, hd), "normal", d ** -0.5),
        (("layers", "attn", "wv"), (L, d, kd), "normal", d ** -0.5),
        (("layers", "ln1"), (L, d), "ones", 0.0),
        (("layers", "ln2"), (L, d), "ones", 0.0),
        (("layers", "moe", "router"), (L, d, X), "normal", d ** -0.5,
         torch.float32),
        (("layers", "moe", "wd"), (L, X, Fe, d), "normal", Fe ** -0.5),
        (("layers", "moe", "wg"), (L, X, d, Fe), "normal", d ** -0.5),
        (("layers", "moe", "wu"), (L, X, d, Fe), "normal", d ** -0.5),
        (("lm_head",), (d, V), "normal", d ** -0.5),
    ]
    return leaves


def matmul_weights(m: dict) -> Dict[str, int]:
    """The weights that multiply each token: the attention's projections,
    the router and the ``top_k`` experts a token is routed to."""
    d, H, K, D = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    moe = m["moe"]
    per_layer = 2 * d * H * D + 2 * d * K * D + d * moe["num_experts"] \
        + moe["top_k"] * 3 * d * moe["d_expert"]
    return {"layers": per_layer * m["num_layers"],
            "lm_head": d * m["vocab_size"], "frontend": 0}


def attention_layers(m: dict) -> int:
    return m["num_layers"]


def attention_flops(m: dict, B: int, S: int) -> int:
    """4·D a causal (query, key) pair, every layer."""
    return m["num_layers"] * 4 * m["head_dim"] * B * m["num_heads"] * S \
        * (S + 1) // 2


def attention_bytes(m: dict, B: int, S: int, lse: bool) -> int:
    H, K, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return 2 * B * S * D * (2 * H + 2 * K) + (4 * B * H * S if lse else 0)


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x, theta):
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** -(torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(m, w, h):
    B, S, _ = h.shape
    H, K, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = rope((h @ w["wq"]).reshape(B, S, H, D), m["rope_theta"])
    k = rope((h @ w["wk"]).reshape(B, S, K, D), m["rope_theta"])
    v = (h @ w["wv"]).reshape(B, S, K, D)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * D)
    return o @ w["wo"]


def moe(m, w, h):
    k = m["moe"]["top_k"]
    probs = torch.softmax(h @ w["router"], dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    topw = topw / topw.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(w["wg"].shape[0]):
        weight = (topw * (topi == e)).sum(-1, keepdim=True)
        y = (F.silu(h @ w["wg"][e]) * (h @ w["wu"][e])) @ w["wd"][e]
        out = out + weight * y
    return out


def last_logits(m: dict, weights: dict, tokens: torch.Tensor, *,
                fp8: bool = False) -> torch.Tensor:
    """(B, S) prompts -> (B, V) float32 logits of the last position."""
    if fp8:
        raise ValueError("the fixture has no fp8 control")
    torch.backends.cuda.matmul.allow_tf32 = False
    L = weights["layers"]
    with torch.no_grad():
        x = weights["embed"].float()[tokens.long()]
        for i in range(m["num_layers"]):
            w = {k: v[i].float() for k, v in
                 {**L["attn"], **L["moe"]}.items()}
            x = x + attention(m, w, rms_norm(x, L["ln1"][i].float(),
                                             m["rms_eps"]))
            x = x + moe(m, w, rms_norm(x, L["ln2"][i].float(),
                                       m["rms_eps"]))
        x = rms_norm(x[:, -1], weights["final_norm"].float(), m["rms_eps"])
        return x @ weights["lm_head"].float()
