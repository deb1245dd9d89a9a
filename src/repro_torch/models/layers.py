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
        along its first axis (one slab, the whole leaf, for all but the
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
        rows = max(1, SLAB_ELEMENTS // (out.numel() // self.shape[0]))
        for i in range(0, self.shape[0], rows):
            part = out[i:i + rows]
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       .mul_(std))
        return out


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
    run the kernel alone."""
    B, S, _ = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(p, x, cfg, positions)
    kv = (k, v)
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
    k, dh = cfg.num_kv_heads, cfg.head_dim
    spec = ParamSpec((batch, max_seq, k, dh),
                     ("batch", "kv_seq", "kv_heads", None),
                     init="zeros", dtype=dtype)
    return {"k": spec, "v": spec}
