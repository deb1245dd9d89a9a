"""The dense family (``dense``, ``audio``, ``vlm``: attention + MLP a
layer) as the harness sees it: its weight layout, its FLOP and byte
counts, and its plain reference in float32.  A configuration names its
family module with ``"reference"``; this is the one taken without it.

One layer: ``x + attn(rms_norm(x))``, then ``x + mlp(rms_norm(x))``;
attention is causal softmax attention over rotary positions (the
rotate-half form), the key/value heads shared by ``H / K`` query heads
(multi-query at K = 1); the MLP is ``gelu_tanh(x Wu) Wd`` or
``(silu(x Wg) * x Wu) Wd``.  The audio front end adds ``frames Wf`` to
the token embedding.  The loss is the mean next-token cross entropy, and
AdamW follows the configuration's optimizer group: the global gradient
norm clipped, bias-corrected moments, decoupled weight decay, a warmup
then cosine learning rate, parameters stored in their own type (bf16).

Every product runs in float32 with TF32 off.  ``fp8=True`` is the
control: both operands of every weight product rounded to float8 e4m3,
each tensor scaled so its largest magnitude maps to 448 (the format's
largest), as an fp8 GEMM would take them.

It reads the weights and inputs the harness drew, upcasts a layer's
weights as it reaches them, and imports only ``torch``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


# ---------------------------------------------------------------------------
# The weights' layout and the work's counts
# ---------------------------------------------------------------------------


def layout(m: dict) -> List[tuple]:
    """Every weight as the port lays it out, in draw order: (path, shape,
    init, std), bf16 (a fifth item would give another type).  Stacked
    ``(L, ...)`` layers, ``x @ W`` matrices of (fan_in, fan_out), norms as
    gains, a separate LM head unless tied.  A matrix is drawn N(0,
    1/fan_in), the embedding N(0, 0.02^2), a gain is 1."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    hd = m["num_heads"] * m["head_dim"]
    kd = m["num_kv_heads"] * m["head_dim"]
    F = m["d_ff"]
    mats = {("attn", "wq"): (d, hd), ("attn", "wk"): (d, kd),
            ("attn", "wv"): (d, kd), ("attn", "wo"): (hd, d),
            ("mlp", "wu"): (d, F), ("mlp", "wd"): (F, d)}
    if m["mlp_type"] == "swiglu":
        mats[("mlp", "wg")] = (d, F)
    leaves = [(("embed",), (V, d), "normal", 0.02),
              (("final_norm",), (d,), "ones", 0.0)]
    if not m["tie_embeddings"]:
        leaves.append((("lm_head",), (d, V), "normal", d ** -0.5))
    if m["frontend"] != "none":
        leaves.append((("frontend_proj",), (m["frontend_dim"], d),
                       "normal", m["frontend_dim"] ** -0.5))
    leaves += [(("layers", "ln1"), (L, d), "ones", 0.0),
               (("layers", "ln2"), (L, d), "ones", 0.0)]
    for (group, name), (fi, fo) in sorted(mats.items()):
        leaves.append((("layers", group, name), (L, fi, fo), "normal",
                       fi ** -0.5))
    if m["qkv_bias"]:
        raise ValueError("the harness draws no attention biases")
    return sorted(leaves, key=lambda s: s[0])


def matmul_weights(m: dict) -> Dict[str, int]:
    """Weight elements that multiply each token in a product, by part:
    the layers' projections and MLP, the LM head, the front end's
    projector.  The embedding is gathered, not multiplied."""
    d = m["d_model"]
    per_layer = sum(math.prod(shape[1:]) for path, shape, *_ in layout(m)
                    if path[0] == "layers" and len(shape) == 3)
    return {"layers": per_layer * m["num_layers"],
            "lm_head": d * m["vocab_size"],
            "frontend": m["frontend_dim"] * d if m["frontend"] != "none"
            else 0}


def attended_pairs(B: int, H: int, S: int) -> int:
    """(query, key) pairs of causal attention over S positions."""
    return B * H * S * (S + 1) // 2


def attention_layers(m: dict) -> int:
    """The layers that run attention: every one."""
    return m["num_layers"]


def attention_flops(m: dict, B: int, S: int) -> int:
    """One causal attention forward of every layer: 2·D for q·k and 2·D
    for p·v a pair, at the real head dim."""
    return m["num_layers"] * 4 * m["head_dim"] * attended_pairs(
        B, m["num_heads"], S)


def attention_backward_flops(m: dict, B: int, S: int) -> int:
    """One causal attention backward of every layer: 10·D a pair (the
    scores recomputed, dV, dP, dQ, dK)."""
    return m["num_layers"] * 10 * m["head_dim"] * attended_pairs(
        B, m["num_heads"], S)


def attention_bytes(m: dict, B: int, S: int, lse: bool) -> int:
    """One layer's attention forward, each byte read or written once:
    bf16 queries and outputs of every head, keys and values of the
    key/value heads, and with ``lse`` its (B, H, S) f32 log-sum-exp."""
    H, K, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    n = 2 * B * S * D * (2 * H + 2 * K)
    return n + (4 * B * H * S if lse else 0)


# ---------------------------------------------------------------------------
# The reference's forward
# ---------------------------------------------------------------------------


def exact_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through per-tensor-scaled e4m3 and back; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = E4M3_MAX / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    return x @ w


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(B, S, H, D): position p turns the pair (i, i + D/2) by
    p·θ^(-2i/D)."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** -(torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


#: the most bytes of f32 scores one slice of query heads may hold
SCORE_BYTES = 1 << 30


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, (B, S, H, D) queries over (B, S, K, D)
    keys and values, as many query heads at a time as keep their scores
    within :data:`SCORE_BYTES`."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    head_chunk = max(1, SCORE_BYTES // (B * S * S * 4))
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    outs = []
    for h0 in range(0, H, head_chunk):
        hs = range(h0, min(H, h0 + head_chunk))
        qh = q[:, :, h0:hs[-1] + 1].transpose(1, 2)             # (B,h,S,D)
        kv = torch.tensor([h // G for h in hs], device=q.device)
        kh = k.transpose(1, 2)[:, kv]
        vh = v.transpose(1, 2)[:, kv]
        s = (qh @ kh.transpose(-1, -2)) / math.sqrt(D)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        outs.append((p @ vh).transpose(1, 2))
    return torch.cat(outs, dim=2)


def layer(m: dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
          fp8: bool) -> torch.Tensor:
    B, S, _ = x.shape
    H, K, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = rms_norm(x, w["ln1"], m["rms_eps"])
    q = rope(linear(h, w["wq"], fp8).reshape(B, S, H, D), m["rope_theta"])
    k = rope(linear(h, w["wk"], fp8).reshape(B, S, K, D), m["rope_theta"])
    v = linear(h, w["wv"], fp8).reshape(B, S, K, D)
    o = attention(q, k, v).reshape(B, S, H * D)
    x = x + linear(o, w["wo"], fp8)
    h = rms_norm(x, w["ln2"], m["rms_eps"])
    if m["mlp_type"] == "gelu":
        u = F.gelu(linear(h, w["wu"], fp8), approximate="tanh")
    else:
        u = F.silu(linear(h, w["wg"], fp8)) * linear(h, w["wu"], fp8)
    return x + linear(u, w["wd"], fp8)


def layer_weights(weights: dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights from the stacked bf16 tree, in float32."""
    L = weights["layers"]
    w = {"ln1": L["ln1"][i], "ln2": L["ln2"][i]}
    w.update(L["attn"])
    w.update(L["mlp"])
    return {k: (v if k in ("ln1", "ln2") else v[i]).float()
            for k, v in w.items()}


def embed(m: dict, weights: dict, tokens: torch.Tensor,
          frames: Optional[torch.Tensor], fp8: bool) -> torch.Tensor:
    x = weights["embed"].float()[tokens.long()]
    if m["frontend"] == "audio_frames":
        x = x + linear(frames.float(), weights["frontend_proj"].float(), fp8)
    return x


def head_weight(m: dict, weights: dict) -> torch.Tensor:
    return weights["embed"].T if m["tie_embeddings"] else weights["lm_head"]


def last_logits(m: dict, weights: dict, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None, *, fp8: bool = False
                ) -> torch.Tensor:
    """(B, S) prompts -> (B, V) float32 logits of the last position,
    a layer at a time."""
    exact_f32()
    with torch.no_grad():
        x = embed(m, weights, tokens, frames, fp8)
        for i in range(m["num_layers"]):
            x = layer(m, layer_weights(weights, i), x, fp8)
        x = rms_norm(x[:, -1], weights["final_norm"].float(), m["rms_eps"])
        return linear(x, head_weight(m, weights).float(), fp8)


# ---------------------------------------------------------------------------
# Training: loss, gradients, AdamW
# ---------------------------------------------------------------------------


def _tree_paths(tree, prefix=()) -> List[Tuple[str, ...]]:
    if isinstance(tree, torch.Tensor):
        return [prefix]
    return [p for k in sorted(tree)
            for p in _tree_paths(tree[k], prefix + (k,))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def loss(m: dict, params: dict, batch: Dict[str, torch.Tensor],
         fp8: bool) -> torch.Tensor:
    """Mean next-token cross entropy of a batch, each layer recomputed in
    the backward (``torch.utils.checkpoint``) so one layer's attention
    lives at a time."""
    x = embed(m, params, batch["tokens"], batch.get("frames"), fp8)
    L = params["layers"]
    for i in range(m["num_layers"]):
        w = {"ln1": L["ln1"][i], "ln2": L["ln2"][i]}
        w.update({k: v[i] for k, v in L["attn"].items()})
        w.update({k: v[i] for k, v in L["mlp"].items()})
        x = checkpoint(lambda xx, ww: layer(m, ww, xx, fp8),
                       x, w, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], m["rms_eps"])
    logits = linear(x.reshape(-1, x.shape[-1]), head_weight(m, params), fp8)
    return F.cross_entropy(logits, batch["labels"].reshape(-1).long())


def learning_rate(opt: dict, step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine to
    ``floor`` × ``lr`` at ``total_steps``."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    return lr * (opt["floor"] + (1 - opt["floor"]) * 0.5 *
                 (1 + math.cos(math.pi * prog)))


def train(m: dict, opt: dict, weights: dict, batches: List[dict], *,
          fp8: bool = False,
          first_grad: Optional[Callable[[str, torch.Tensor], None]] = None
          ) -> dict:
    """AdamW from ``weights`` (bf16, left as they are) over ``batches``,
    the first at step 0.  -> {"loss": [each step's],
    "grad_norms": {leaf: the clipped gradient's norm at the first step},
    "change_norms": {leaf: |params after the last step - weights|}};
    ``first_grad(leaf, g)`` is handed each leaf's clipped gradient of the
    first step, to judge another side's by."""
    exact_f32()
    paths = _tree_paths(weights)
    stored = {p: _get(weights, p).clone() for p in paths}
    mom = {p: torch.zeros_like(stored[p], dtype=torch.float32) for p in paths}
    var = {p: torch.zeros_like(stored[p], dtype=torch.float32) for p in paths}
    b1, b2 = opt["beta1"], opt["beta2"]
    out = {"loss": [], "grad_norms": {}, "change_norms": {}}
    for n, batch in enumerate(batches):
        live = {p: stored[p].to(torch.float32, copy=True).requires_grad_()
                for p in paths}
        tree: dict = {}
        for p in paths:
            _set(tree, p, live[p])
        value = loss(m, tree, batch, fp8)
        grads = torch.autograd.grad(value, [live[p] for p in paths])
        del live, tree
        out["loss"].append(float(value.detach()))
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = min(1.0, opt["grad_clip"] / max(float(norm), 1e-9))
        step = n
        lr = learning_rate(opt, step)
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        for p, g in zip(paths, grads):
            if n == 0:
                out["grad_norms"][".".join(p)] = float(g.norm()) * scale
                if first_grad is not None:
                    first_grad(".".join(p), g * scale)
            # a layer of a stacked leaf at a time: f32 temporaries of one
            # layer, not of the whole stack
            rows = range(g.shape[0]) if g.dim() == 3 else [slice(None)]
            for r in rows:
                gr = g[r] * scale
                mr, vr = mom[p][r], var[p][r]
                mr.mul_(b1).add_(gr, alpha=1 - b1)
                vr.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                upd = (mr / c1) / (torch.sqrt(vr / c2) + opt["eps"])
                w = stored[p][r].float()
                stored[p][r] = (w - lr * (upd + opt["weight_decay"] * w)
                                ).to(stored[p].dtype)
        del grads
    for p in paths:
        out["change_norms"][".".join(p)] = float(
            (stored[p].float() - _get(weights, p).float()).norm())
    return out
