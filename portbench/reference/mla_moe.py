"""DeepSeek-V3's block as Moonlight-16B-A3B has it (the port's ``moe``
family with latent attention, leading dense layers and a dropless
sigmoid-routed MoE) as the harness sees it: its weight layout, its FLOP
and byte counts, and its plain reference in float32.

One layer: ``x + mla(rms_norm(x))``, then ``x + ffn(rms_norm(x))``, the
FFN a SwiGLU MLP in the first ``first_dense_layers`` layers and the MoE
in the others.  Latent attention (DeepSeek-V2 §2.1, without a query
latent), per head::

    q = h W_q = [q_nope, q_rope]            q_rope rotated
    [c, k_rope] = h W_kv_a                  k_rope rotated, one for all heads
    [k_nope, v] = rms_norm(c) W_kv_b
    o = softmax([q_nope, q_rope] . [k_nope, k_rope] / sqrt(dn + dr)) v

causal, then ``o W_o``.  The MoE (DeepSeek-V3 §2.1.2): scores s =
sigmoid(h W_r) in f32; the top-k experts of s + b (the correction bias;
ties to the lower id); their weights the chosen s renormalised to sum to
1 (``norm_topk_prob``) and times ``routed_scale``; the output
``sum_e w_e swiglu_e(h) + swiglu_shared(h)``, where the shared experts
are one SwiGLU of ``num_shared_experts * d_expert`` (those four under
``sigmoid_moe``, the experts' sizes under ``moe``).  Every assignment
is computed: no capacity, no token dropped.

Departures from the published model, as the configuration's
``assumed`` lists them: the rotary dims in the rotate-half form (the
checkpoints' interleaved pairs are a fixed permutation of W_q's and
W_kv_a's rotary columns), no rope scaling (none is configured), the
router's group selection left out (one group: ``n_group`` 1 keeps every
expert), and random weights.

``choices`` replays another side's expert choices: each MoE layer's
(B, S, k) expert ids in place of the router's own top-k, the weights
still this side's f32 scores of those experts.  With random weights a
token whose (k)th and (k+1)th scores lie within rounding picks another
expert in bf16 than in f32, and at the published depth such flips feed
each other until the last logits of the two sides are unrelated
(``PERF.md`` §2); replaying the program's choices leaves the rounding of
every product to be compared.  The choices themselves are checked as
they are replayed: ``misses`` counts, a layer at a time, the replayed
experts whose biased score (this side's own, on its own hidden state)
lies below its own (k)th, and those below it by more than
:data:`CHOICE_MARGIN`, which no rounding flip reaches.

Every product runs in float32 with TF32 off.  ``fp8=True`` is the
control: both operands of every weight product (the router's too)
rounded to float8 e4m3, each tensor scaled so its largest magnitude maps
to 448, as an fp8 GEMM would take them.  It reads the weights and inputs
the harness drew, upcasts a layer's weights as it reaches them, and
imports only ``torch``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
#: the std of the drawn correction bias: of the order of the gaps between
#: a token's neighbouring sigmoid scores at 64 experts (their spread is
#: ~0.2 at unit-variance router logits), so it changes some choices
#: without deciding most of them
BIAS_STD = 0.05
#: a replayed expert whose biased score lies this far below the
#: reference's (k)th was not a near tie that rounding flipped: bf16 hidden
#: states move a unit-variance router logit by a few hundredths, a
#: sigmoid score (slope at most 1/4) by under 0.01, and a gap of two
#: scores by under 0.02
CHOICE_MARGIN = 0.02


# ---------------------------------------------------------------------------
# The weights' layout and the work's counts
# ---------------------------------------------------------------------------


def _dims(m: dict):
    a = m["mla"]
    return (a["kv_lora_rank"], a["qk_nope_head_dim"], a["qk_rope_head_dim"],
            a["v_head_dim"])


def _attn_mats(m: dict) -> Dict[str, tuple]:
    d, H = m["d_model"], m["num_heads"]
    r, dn, dr, dv = _dims(m)
    return {"wq": (d, H * (dn + dr)), "wkv_a": (d, r + dr),
            "wkv_b": (r, H * (dn + dv)), "wo": (H * dv, d)}


def layout(m: dict) -> List[tuple]:
    """Every weight as the port lays it out, in draw order: (path, shape,
    init, std[, type]).  The leading dense layers stacked under
    ``dense_layers``, the MoE layers under ``layers``; ``x @ W`` matrices
    of (fan_in, fan_out) drawn N(0, 1/fan_in), experts stacked (X, fan_in,
    fan_out), the router (f32) N(0, 1/d), the correction bias (f32) N(0,
    :data:`BIAS_STD`^2), the embedding N(0, 0.02^2), norm gains 1."""
    d, V, moe = m["d_model"], m["vocab_size"], m["moe"]
    n_dense = m["first_dense_layers"]
    n_moe = m["num_layers"] - n_dense
    r = _dims(m)[0]
    X, Fe = moe["num_experts"], moe["d_expert"]
    Fs = m["sigmoid_moe"]["num_shared_experts"] * Fe
    leaves = [(("embed",), (V, d), "normal", 0.02),
              (("final_norm",), (d,), "ones", 0.0),
              (("lm_head",), (d, V), "normal", d ** -0.5)]

    def block(stack: str, n: int) -> None:
        leaves.append(((stack, "attn", "kv_norm"), (n, r), "ones", 0.0))
        for name, (fi, fo) in _attn_mats(m).items():
            leaves.append(((stack, "attn", name), (n, fi, fo), "normal",
                           fi ** -0.5))
        leaves.extend([((stack, "ln1"), (n, d), "ones", 0.0),
                       ((stack, "ln2"), (n, d), "ones", 0.0)])

    if n_dense:
        block("dense_layers", n_dense)
        Fd = m["d_ff"]
        leaves += [(("dense_layers", "mlp", "wg"), (n_dense, d, Fd),
                    "normal", d ** -0.5),
                   (("dense_layers", "mlp", "wu"), (n_dense, d, Fd),
                    "normal", d ** -0.5),
                   (("dense_layers", "mlp", "wd"), (n_dense, Fd, d),
                    "normal", Fd ** -0.5)]
    block("layers", n_moe)
    leaves += [(("layers", "moe", "router"), (n_moe, d, X), "normal",
                d ** -0.5, torch.float32),
               (("layers", "moe", "bias"), (n_moe, X), "normal", BIAS_STD,
                torch.float32),
               (("layers", "moe", "wg"), (n_moe, X, d, Fe), "normal",
                d ** -0.5),
               (("layers", "moe", "wu"), (n_moe, X, d, Fe), "normal",
                d ** -0.5),
               (("layers", "moe", "wd"), (n_moe, X, Fe, d), "normal",
                Fe ** -0.5),
               (("layers", "moe", "shared", "wg"), (n_moe, d, Fs), "normal",
                d ** -0.5),
               (("layers", "moe", "shared", "wu"), (n_moe, d, Fs), "normal",
                d ** -0.5),
               (("layers", "moe", "shared", "wd"), (n_moe, Fs, d), "normal",
                Fs ** -0.5)]
    return sorted(leaves, key=lambda s: s[0])


def moe_layers(m: dict) -> int:
    return m["num_layers"] - m["first_dense_layers"]


def matmul_weights(m: dict) -> Dict[str, int]:
    """Weight elements that multiply each token, by part: every layer's
    latent attention (W_q, W_kv_a, W_kv_b, W_o), the dense layers' MLP,
    and of each MoE layer the router, the shared experts and the ``top_k``
    routed experts a token goes to; the LM head.  The embedding is
    gathered, not multiplied."""
    d, moe = m["d_model"], m["moe"]
    attn = sum(fi * fo for fi, fo in _attn_mats(m).values())
    Fe = moe["d_expert"]
    per_moe = d * moe["num_experts"] \
        + 3 * d * Fe * (moe["top_k"]
                        + m["sigmoid_moe"]["num_shared_experts"])
    layers = attn * m["num_layers"] \
        + m["first_dense_layers"] * 3 * d * m["d_ff"] + moe_layers(m) * per_moe
    return {"layers": layers, "lm_head": d * m["vocab_size"], "frontend": 0}


def attended_pairs(B: int, H: int, S: int) -> int:
    """(query, key) pairs of causal attention over S positions."""
    return B * H * S * (S + 1) // 2


def attention_layers(m: dict) -> int:
    """The layers that run attention: every one."""
    return m["num_layers"]


def attention_flops(m: dict, B: int, S: int) -> int:
    """One causal attention forward of every layer: 2·(dn + dr) for q·k
    and 2·dv for p·v a pair and head (640 at Moonlight's widths)."""
    _, dn, dr, dv = _dims(m)
    return m["num_layers"] * 2 * (dn + dr + dv) * attended_pairs(
        B, m["num_heads"], S)


def attention_bytes(m: dict, B: int, S: int, lse: bool) -> int:
    """One layer's attention forward, each byte read or written once, as
    kernel 7 takes it: bf16 queries and keys of every head at dn + dr,
    values and outputs at dv, and with ``lse`` its (B, H, S) f32
    log-sum-exp."""
    _, dn, dr, dv = _dims(m)
    H = m["num_heads"]
    return 2 * B * S * H * (2 * (dn + dr) + 2 * dv) \
        + (4 * B * H * S if lse else 0)


def routed_expert_flops(m: dict, tokens: int) -> int:
    """The routed experts' products over ``tokens`` tokens, every MoE
    layer: 2·3·d·d_expert an assignment, ``top_k`` assignments a
    token."""
    moe = m["moe"]
    return moe_layers(m) * tokens * moe["top_k"] * 2 * 3 * m["d_model"] \
        * moe["d_expert"]


def routed_expert_bytes(m: dict, tokens: int) -> int:
    """Their least bytes, every MoE layer: each expert's three bf16
    matrices read once (every expert sees tokens at a cell's batch), each
    assignment's input row read once and its output row written once."""
    moe, d = m["moe"], m["d_model"]
    weights = 3 * moe["num_experts"] * d * moe["d_expert"]
    rows = 2 * tokens * moe["top_k"] * d
    return moe_layers(m) * 2 * (weights + rows)


# ---------------------------------------------------------------------------
# The reference's forward
# ---------------------------------------------------------------------------


def exact_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through per-tensor-scaled e4m3 and back."""
    amax = x.abs().amax().float().clamp_min(1e-30)
    s = E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


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
    """Causal softmax attention of (B, S, H, Dqk) queries over keys of the
    same shape and (B, S, H, Dv) values, scale 1/sqrt(Dqk), as many heads
    at a time as keep their scores within :data:`SCORE_BYTES`."""
    B, S, H, D = q.shape
    head_chunk = max(1, SCORE_BYTES // (B * S * S * 4))
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    outs = []
    for h0 in range(0, H, head_chunk):
        h1 = min(H, h0 + head_chunk)
        qh, kh, vh = (t[:, :, h0:h1].transpose(1, 2) for t in (q, k, v))
        s = (qh @ kh.transpose(-1, -2)) / math.sqrt(D)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        outs.append((p @ vh).transpose(1, 2))
    return torch.cat(outs, dim=2)


def mla(m: dict, w: Dict[str, torch.Tensor], h: torch.Tensor,
        fp8: bool) -> torch.Tensor:
    B, S, _ = h.shape
    H = m["num_heads"]
    r, dn, dr, dv = _dims(m)
    q = linear(h, w["wq"], fp8).reshape(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], m["rope_theta"])], dim=-1)
    kv_a = linear(h, w["wkv_a"], fp8)
    k_rope = rope(kv_a[:, :, None, r:], m["rope_theta"])
    c = rms_norm(kv_a[..., :r], w["kv_norm"], m["rms_eps"])
    kv = linear(c, w["wkv_b"], fp8).reshape(B, S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_rope.expand(B, S, H, dr)], dim=-1)
    o = attention(q, k, kv[..., dn:]).reshape(B, S, H * dv)
    return linear(o, w["wo"], fp8)


def swiglu(h, wg, wu, wd, fp8: bool) -> torch.Tensor:
    return linear(F.silu(linear(h, wg, fp8)) * linear(h, wu, fp8), wd, fp8)


def route(m: dict, w: Dict[str, torch.Tensor], h: torch.Tensor,
          fp8: bool, choice: Optional[torch.Tensor] = None,
          misses: Optional[List[tuple]] = None):
    """(T, E) -> (weights (T, k), expert ids (T, k)) of the sigmoid
    router: chosen by score + bias, ties to the lower id, or the (T, k)
    ``choice`` given; then ``misses`` gains (the given experts whose
    biased score lies below the (k)th, those below it by more than
    :data:`CHOICE_MARGIN`, the experts given)."""
    sm, k = m["sigmoid_moe"], m["moe"]["top_k"]
    scores = torch.sigmoid(linear(h, w["router"], fp8))
    biased = scores + w["bias"]
    if choice is None:
        _, topi = torch.sort(biased, dim=-1, descending=True, stable=True)
        topi = topi[:, :k]
    else:
        topi = choice.to(device=h.device, dtype=torch.long)
        if misses is not None:
            short = biased.topk(k, dim=-1).values[:, -1:] \
                - biased.gather(1, topi)
            misses.append((int((short > 0).sum()),
                           int((short > CHOICE_MARGIN).sum()), short.numel()))
    topw = scores.gather(1, topi)
    topw = topw / (topw.sum(-1, keepdim=True) + 1e-20)
    return topw * sm["routed_scale"], topi


def moe(m: dict, w: Dict[str, torch.Tensor], h: torch.Tensor,
        fp8: bool, choice: Optional[torch.Tensor] = None,
        misses: Optional[List[tuple]] = None) -> torch.Tensor:
    """The routed experts, each on the tokens routed to it, weighted, and
    the shared experts on every token; (B, S, E) -> (B, S, E).
    ``choice``: (B, S, k) expert ids to take in place of the router's,
    checked into ``misses`` (:func:`route`)."""
    B, S, E = h.shape
    hf = h.reshape(B * S, E)
    topw, topi = route(m, w, hf, fp8, None if choice is None
                       else choice.reshape(B * S, -1), misses)
    out = swiglu(hf, w["shared.wg"], w["shared.wu"], w["shared.wd"], fp8)
    for e in range(m["moe"]["num_experts"]):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if len(tok):
            y = swiglu(hf[tok], w["wg"][e], w["wu"][e], w["wd"][e], fp8)
            out.index_add_(0, tok, y * topw[tok, slot][:, None])
    return out.reshape(B, S, E)


def layer_weights(weights: dict, m: dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights (of all ``num_layers``) from the stacked bf16
    tree, in float32; the shared experts' under ``shared.*``."""
    n_dense = m["first_dense_layers"]
    stack, j = (weights["dense_layers"], i) if i < n_dense \
        else (weights["layers"], i - n_dense)
    w = {"ln1": stack["ln1"][j], "ln2": stack["ln2"][j]}
    w.update({k: v[j] for k, v in stack["attn"].items()})
    if "mlp" in stack:
        w.update({k: v[j] for k, v in stack["mlp"].items()})
    else:
        w.update({k: v[j] for k, v in stack["moe"].items()
                  if k != "shared"})
        w.update({f"shared.{k}": v[j]
                  for k, v in stack["moe"]["shared"].items()})
    return {k: v.float() for k, v in w.items()}


def last_logits(m: dict, weights: dict, tokens: torch.Tensor, *,
                fp8: bool = False,
                choices: Optional[Sequence[torch.Tensor]] = None,
                misses: Optional[List[tuple]] = None
                ) -> torch.Tensor:
    """(B, S) prompts -> (B, V) float32 logits of the last position, a
    layer at a time.  ``choices``: the (B, S, k) expert ids of each MoE
    layer in order, replayed in place of the router's, and checked into
    ``misses`` a layer at a time (:func:`route`)."""
    exact_f32()
    n_dense = m["first_dense_layers"]
    with torch.no_grad():
        x = weights["embed"].float()[tokens.long()]
        for i in range(m["num_layers"]):
            w = layer_weights(weights, m, i)
            x = x + mla(m, w, rms_norm(x, w["ln1"], m["rms_eps"]), fp8)
            h = rms_norm(x, w["ln2"], m["rms_eps"])
            if i < n_dense:
                x = x + swiglu(h, w["wg"], w["wu"], w["wd"], fp8)
            else:
                x = x + moe(m, w, h, fp8, None if choices is None
                            else choices[i - n_dense], misses)
            del w
        x = rms_norm(x[:, -1], weights["final_norm"].float(), m["rms_eps"])
        return linear(x, weights["lm_head"].float(), fp8)
