"""Shared components of the dense LM: param templates, norms, RoPE,
attention (port of ``repro/models/layers.py``, the dense-path subset).

Conventions
-----------
* Params are nested dicts of tensors; their *templates* are nested dicts
  of :class:`ParamSpec` carrying shape + logical axis names.  The model
  is a plain dict of tensors behind plain functions, not an
  ``nn.Module``: the reference's param pytree then maps onto it key for
  key (:func:`repro_torch.interop.lm_params_from_numpy`), the layer stack
  keeps its leading ``(L, ...)`` axis (a layer's weights are views into
  it, no copies).  Training differentiates through these functions with
  ``torch.autograd`` (:mod:`repro_torch.train.steps`).
* Activations are bf16; softmax / norms accumulate f32, with the
  reference's casts in the reference's order.
* einsum letters: B batch, S seq, H q-heads, K kv-heads, G q-heads per kv
  head, D head_dim, E d_model, F d_ff, V vocab.
* There is no ``MeshContext`` argument: the port runs on one card, where
  the reference's ``ctx.constrain`` calls have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.flash import flash_attention, flash_forward_plain
from repro_torch.models.hier_attn import hier_causal_attention
from repro_torch.obs import trace

Params = Any  # nested dict of tensors
#: the most values a leaf is drawn in at once (1 GiB of f32): larger
#: leaves are drawn in slabs (:meth:`ParamSpec.initialize`); every leaf of
#: llama3.2-1b (its 128,256 x 2,048 embedding is 262,668,288) is drawn whole
SLAB_ELEMENTS = 1 << 28


# ---------------------------------------------------------------------------
# Param templates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def initialize(self, generator: torch.Generator,
                   device="cuda") -> torch.Tensor:
        """Draw the tensor from ``generator`` (which must live on
        ``device``): N(0, std^2) in f32, then cast, as the reference.  The
        leaf is drawn in slabs of at most :data:`SLAB_ELEMENTS` values
        (:func:`_slabs`: one slab, the whole leaf, for all but the
        largest), each cast into the result as it is drawn, so the f32
        temporary is one slab, not the leaf (moonshot's stacked expert
        leaf, 8.86e9 values, would need 35 GB of f32)."""
        dt = self.torch_dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        out = torch.empty(self.shape, dtype=dt, device=device)
        for part in _slabs(out):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       .mul_(std))
        return out


def _slabs(t: torch.Tensor):
    """``t`` as consecutive views of at most :data:`SLAB_ELEMENTS` values,
    in its order: runs of whole rows along the first axis, and a row that
    alone holds more (kimi-k2's (1, 384, 7168, 2048) expert leaf at one
    layer: 5.64e9 values, 22.5 GB of f32) in its own slabs along the next
    axis, and so on down."""
    if t.numel() <= SLAB_ELEMENTS:
        yield t
        return
    row = t.numel() // t.shape[0]
    if row > SLAB_ELEMENTS:
        for i in range(t.shape[0]):
            yield from _slabs(t[i])
        return
    rows = SLAB_ELEMENTS // row
    for i in range(0, t.shape[0], rows):
        yield t[i:i + rows]


def tree_map_specs(fn: Callable[[ParamSpec], Any], template: Params) -> Params:
    if isinstance(template, ParamSpec):
        return fn(template)
    return {k: tree_map_specs(fn, v) for k, v in template.items()}


def template_leaves(template: Params) -> List[ParamSpec]:
    """The specs of a template, in its (sorted-key) traversal order."""
    if isinstance(template, ParamSpec):
        return [template]
    return [s for k in sorted(template) for s in template_leaves(template[k])]


def abstract_from_template(template: Params) -> Params:
    """Every leaf as an empty ``meta`` tensor of its shape and type: the
    tree without its data (the reference's ``ShapeDtypeStruct``s)."""
    return tree_map_specs(lambda s: torch.empty(s.shape, dtype=s.torch_dtype,
                                                device="meta"), template)


def init_from_template(template: Params, generator: torch.Generator,
                       device="cuda") -> Params:
    """Every leaf drawn in turn from one generator, keys in sorted order."""
    if isinstance(template, ParamSpec):
        return template.initialize(generator, device)
    return {k: init_from_template(template[k], generator, device)
            for k in sorted(template)}


def stacked(spec: ParamSpec, n: int, axis_name: Optional[str] = "layers"
            ) -> ParamSpec:
    """Prepend a layers dimension to a spec."""
    return dataclasses.replace(
        spec, shape=(n, *spec.shape), logical=(axis_name, *spec.logical))


def stack_template(template: Params, n: int) -> Params:
    return tree_map_specs(lambda s: stacked(s, n), template)


def layer(stack: Params, i: int) -> Params:
    """Layer ``i`` of a stacked param (or cache) tree, as views."""
    if isinstance(stack, torch.Tensor):
        return stack[i]
    return {k: layer(v, i) for k, v in stack.items()}


def unstack(stack: Params, n: int) -> List[Params]:
    """Every layer of a stacked tree, as views: one ``unbind`` a leaf, so
    autograd stacks the layers' gradients once (``stack[i]`` for each
    layer would scatter each into a zeroed copy of the whole leaf)."""
    if isinstance(stack, torch.Tensor):
        return list(stack.unbind(0))
    per_key = {k: unstack(v, n) for k, v in stack.items()}
    return [{k: per_key[k][i] for k in per_key} for i in range(n)]


# ---------------------------------------------------------------------------
# Basic ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def rope_frequencies(head_dim: int, theta: float, device="cuda"
                     ) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (D/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  The
    non-interleaved halves, angles in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def attention_template(cfg) -> Dict[str, ParamSpec]:
    if cfg.mla is not None:
        return mla_template(cfg)
    d, h, k, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, h * dh), ("embed", "heads")),
        "wk": ParamSpec((d, k * dh), ("embed", "kv_heads")),
        "wv": ParamSpec((d, k * dh), ("embed", "kv_heads")),
        "wo": ParamSpec((h * dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((h * dh,), ("heads",), init="zeros")
        t["bk"] = ParamSpec((k * dh,), ("kv_heads",), init="zeros")
        t["bv"] = ParamSpec((k * dh,), ("kv_heads",), init="zeros")
    return t


def _project_qkv(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    B, S, _ = x.shape
    h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    kk = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, h, dh), positions, cfg.rope_theta)
    kk = apply_rope(kk.reshape(B, S, k, dh), positions, cfg.rope_theta)
    return q, kk, v.reshape(B, S, k, dh)


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,K*groups,D) by repeating each kv head `groups` times."""
    if groups == 1:
        return x
    B, S, K, D = x.shape
    return x[:, :, :, None, :].expand(B, S, K, groups, D).reshape(
        B, S, K * groups, D)


class _NoBackward(torch.autograd.Function):
    """``"pallas_flash"``: the forward kernel alone.  The reference's
    Pallas call has no VJP, and neither has this: its backward raises."""

    @staticmethod
    def forward(ctx, q, k, v):
        return flash_ops.flash_attention(q, k, v, causal=True)

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "attn_impl='pallas_flash' has no backward (the reference's "
            "Pallas call has no VJP either); train with attn_impl='flash'")


def mha(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
        q_chunk: int = 512, kv_chunk: int = 1024,
        attn_impl: str = "pallas_flash", return_kv: bool = False):
    """Full (training / prefill) causal self-attention.

    * ``"pallas_flash"`` (serving's default): the flash-attention kernel
      (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`),
      forward only;
    * ``"flash"`` (training's, the reference's default): the custom-VJP
      attention (:func:`repro_torch.models.flash.flash_attention`), kernel
      7 with its log-sum-exp in the forward and the block recompute in
      the backward;
    * ``"chunked"``: the reference's ``chunked_attention``, the online
      softmax over (q_chunk, kv_chunk) blocks in plain torch with autograd
      through it: :func:`repro_torch.models.flash.flash_forward_plain`,
      the flash forward's plain version (its output rounds to q's type,
      as ``mha`` rounds the reference's f32 output);
    * ``"hier"``: the recursive-halving schedule
      (:func:`repro_torch.models.hier_attn.hier_causal_attention`).

    The default differs from the reference's ``"flash"``: the reference's
    model calls name their schedule, and the port's prefill and decode
    run the kernel alone.  With grouped KV heads the expansion of K and
    V to the query heads is the active tracer's span ``attn.kv_expand``
    (:func:`repro_torch.obs.trace.span`)."""
    B, S, _ = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(p, x, cfg, positions)
    kv = (k, v)
    if groups > 1:
        with trace.span("attn.kv_expand"):
            k = repeat_kv(k, groups)
            v = repeat_kv(v, groups)
    if attn_impl == "pallas_flash":
        out = _NoBackward.apply(q, k, v)
    elif attn_impl == "chunked":
        out, _ = flash_forward_plain(q, k, v, True, q_chunk, kv_chunk)
    elif attn_impl == "hier":
        out = hier_causal_attention(q, k, v, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk)
    elif attn_impl == "flash":
        out = flash_attention(q, k, v, True, q_chunk, kv_chunk)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    y = out.reshape(B, S, -1).to(x.dtype) @ p["wo"]
    if return_kv:
        return y, kv
    return y


def mha_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg, *, pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with a KV cache (grouped einsum — KV is *not*
    repeated to H heads, so cache reads stay at the GQA byte count).

    cache: {"k": (B, Smax, K, D), "v": (B, Smax, K, D)}, updated **in
    place** at ``pos`` (the reference builds a new cache and donates the
    old one); ``pos`` (a Python int, so the decode loop never syncs) is
    the index of the new token (== number of valid cache entries before
    the update).  Returns (y, cache) with the same cache tensors."""
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"mha_decode takes one token, got {S1}")
    K, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    Dh = cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k_new[:, 0].to(ck.dtype)
    cv[:, pos] = v_new[:, 0].to(cv.dtype)
    Smax = ck.shape[1]
    qg = q.reshape(B, K, G, Dh)                       # (B,K,G,D) single token
    s = torch.einsum("BKGD,BSKD->BKGS", qg.float(), ck.float()) \
        / math.sqrt(Dh)
    valid = torch.arange(Smax, device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("BKGS,BSKD->BKGD", w.to(cv.dtype), cv)
    y = out.reshape(B, 1, K * G * Dh).to(x.dtype) @ p["wo"]
    return y, cache


def attention_cache_template(cfg, batch: int, max_seq: int,
                             dtype: str = "bfloat16") -> Dict[str, ParamSpec]:
    if cfg.mla is not None:
        return mla_cache_template(cfg, batch, max_seq, dtype)
    k, dh = cfg.num_kv_heads, cfg.head_dim
    spec = ParamSpec((batch, max_seq, k, dh),
                     ("batch", "kv_seq", "kv_heads", None),
                     init="zeros", dtype=dtype)
    return {"k": spec, "v": spec}


# ---------------------------------------------------------------------------
# Latent attention (MLA: DeepSeek-V2/V3, without a query latent)
# ---------------------------------------------------------------------------
#
# With h the normed input of a layer, per head:
#     q = h W_q = [q_nope (dn), q_rope (dr)],   q_rope rotated at its position
#     [c (r), k_rope (dr)] = h W_kv_a,          k_rope rotated, one for all heads
#     [k_nope (dn), v (dv)] = rms_norm(c) W_kv_b
#     o = softmax([q_nope, q_rope] . [k_nope, k_rope] / sqrt(dn + dr)) v
# and o W_o.  The cache holds the normed latent c and the rotated k_rope,
# r + dr values a token (576 at Moonlight's widths, against 2 H D = 4,096
# for the keys and values of 16 heads of 128).  The rotary dims use the
# rotate-half form of :func:`apply_rope` (DeepSeek's checkpoints rotate
# interleaved pairs, a fixed permutation of W_q's and W_kv_a's rotary
# columns).


def mla_template(cfg) -> Dict[str, ParamSpec]:
    d, h, a = cfg.d_model, cfg.num_heads, cfg.mla
    return {
        "wq": ParamSpec((d, h * a.qk_head_dim), ("embed", "heads")),
        "wkv_a": ParamSpec((d, a.kv_lora_rank + a.qk_rope_head_dim),
                           ("embed", None)),
        "kv_norm": ParamSpec((a.kv_lora_rank,), (None,), init="ones"),
        "wkv_b": ParamSpec((a.kv_lora_rank,
                            h * (a.qk_nope_head_dim + a.v_head_dim)),
                           (None, "heads")),
        "wo": ParamSpec((h * a.v_head_dim, d), ("heads", "embed")),
    }


def mla_cache_template(cfg, batch: int, max_seq: int,
                       dtype: str = "bfloat16") -> Dict[str, ParamSpec]:
    """The latent cache: the normed latent ``ckv`` and the rotated key
    ``kpe`` of every position."""
    a = cfg.mla
    return {
        "ckv": ParamSpec((batch, max_seq, a.kv_lora_rank),
                         ("batch", "kv_seq", None), init="zeros",
                         dtype=dtype),
        "kpe": ParamSpec((batch, max_seq, a.qk_rope_head_dim),
                         ("batch", "kv_seq", None), init="zeros",
                         dtype=dtype),
    }


def _mla_query_latent(p: Params, x: torch.Tensor, cfg,
                      positions: torch.Tensor):
    """-> ((B, S, H, dn) q_nope, (B, S, H, dr) rotated q_rope, (B, S, r)
    latent before its norm, (B, S, dr) rotated k_rope)."""
    B, S, _ = x.shape
    a, h = cfg.mla, cfg.num_heads
    dn, r = a.qk_nope_head_dim, a.kv_lora_rank
    q = (x @ p["wq"]).view(B, S, h, a.qk_head_dim)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"]
    k_rope = apply_rope(kv_a[..., None, r:], positions, cfg.rope_theta)
    return q[..., :dn], q_rope, kv_a[..., :r], k_rope[:, :, 0]


def mla(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor):
    """Latent attention over the full prompt (serving's prefill): the
    per-head keys and values come up from the normed latent, the rotary
    key is broadcast to every head (the active tracer's span
    ``attn.mla_up``), and kernel 7 runs (Dqk, Dv) = (dn + dr, dv) with
    the scale 1/sqrt(dn + dr).  Forward only, as ``"pallas_flash"``.
    -> (y, (normed latent (B, S, r), rotated k_rope (B, S, dr))): the
    output and what the cache holds."""
    B, S, _ = x.shape
    a, h = cfg.mla, cfg.num_heads
    dn = a.qk_nope_head_dim
    q_nope, q_rope, c, k_rope = _mla_query_latent(p, x, cfg, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    with trace.span("attn.mla_up"):
        c = rms_norm(c, p["kv_norm"], cfg.rms_eps)
        kv = (c @ p["wkv_b"]).view(B, S, h, dn + a.v_head_dim)
        k = torch.cat([kv[..., :dn], k_rope[:, :, None].expand(
            B, S, h, a.qk_rope_head_dim)], dim=-1)
        v = kv[..., dn:]
    out = _NoBackward.apply(q, k, v)
    y = out.reshape(B, S, h * a.v_head_dim).to(x.dtype) @ p["wo"]
    return y, (c, k_rope)


def mla_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg, *, pos: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode through the latent cache, in the absorbed form:
    W_kv_b's key half is folded into the query (scores against the latent
    itself) and its value half applied after the weighted latent sum, so
    no position's keys or values are rebuilt.  The cache ({"ckv", "kpe"},
    (B, Smax, .)) is written in place at ``pos`` (a Python int); scores,
    softmax and sums in f32, as :func:`mha_decode`."""
    B, S1, _ = x.shape
    if S1 != 1:
        raise ValueError(f"mla_decode takes one token, got {S1}")
    a, h = cfg.mla, cfg.num_heads
    dn, r = a.qk_nope_head_dim, a.kv_lora_rank
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c, k_rope = _mla_query_latent(p, x, cfg, positions)
    ckv, kpe = cache["ckv"], cache["kpe"]
    ckv[:, pos] = rms_norm(c, p["kv_norm"], cfg.rms_eps)[:, 0].to(ckv.dtype)
    kpe[:, pos] = k_rope[:, 0].to(kpe.dtype)
    w = p["wkv_b"].view(r, h, dn + a.v_head_dim).float()
    q_lat = torch.einsum("BHd,rHd->BHr", q_nope[:, 0].float(), w[..., :dn])
    s = (torch.einsum("BHr,BSr->BHS", q_lat, ckv.float())
         + torch.einsum("BHd,BSd->BHS", q_rope[:, 0].float(), kpe.float())) \
        / math.sqrt(a.qk_head_dim)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    o_lat = torch.einsum("BHS,BSr->BHr", torch.softmax(s, dim=-1),
                         ckv.float())
    o = torch.einsum("BHr,rHd->BHd", o_lat, w[..., dn:])
    y = o.reshape(B, 1, h * a.v_head_dim).to(x.dtype) @ p["wo"]
    return y, cache
