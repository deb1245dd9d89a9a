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
  it, no copies), and nothing here needs autograd (serving only).
* Activations are bf16; softmax / norms accumulate f32, with the
  reference's casts in the reference's order.
* einsum letters: B batch, S seq, H q-heads, K kv-heads, G q-heads per kv
  head, D head_dim, E d_model, F d_ff, V vocab.
* There is no ``MeshContext``: the port runs on one card until ``dist`` is
  ported, so the reference's ``ctx.constrain`` calls have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

Params = Any  # nested dict of tensors


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
        ``device``): N(0, std^2) in f32, then cast, as the reference."""
        dt = self.torch_dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dt)


def tree_map_specs(fn: Callable[[ParamSpec], Any], template: Params) -> Params:
    if isinstance(template, ParamSpec):
        return fn(template)
    return {k: tree_map_specs(fn, v) for k, v in template.items()}


def template_leaves(template: Params) -> List[ParamSpec]:
    """The specs of a template, in its (sorted-key) traversal order."""
    if isinstance(template, ParamSpec):
        return [template]
    return [s for k in sorted(template) for s in template_leaves(template[k])]


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
#: attention schedules of the reference that wait for the training slice
_TRAINING_IMPLS = ("flash", "chunked", "hier")


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


def mha(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
        attn_impl: str = "pallas_flash", return_kv: bool = False):
    """Full (prefill) causal self-attention.

    ``attn_impl="pallas_flash"`` (the only one ported, and so the
    default) runs the flash-attention kernel
    (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`).
    The reference's ``"flash"`` (custom-VJP), ``"chunked"`` and ``"hier"``
    schedules come with the training slice and raise here."""
    if attn_impl in _TRAINING_IMPLS:
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} is not ported: it comes with the "
            f"training slice (ROADMAP Queue 1 item 15); use 'pallas_flash'")
    if attn_impl != "pallas_flash":
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, S, _ = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _project_qkv(p, x, cfg, positions)
    kv = (k, v)
    out = flash_ops.flash_attention(q, repeat_kv(k, groups),
                                    repeat_kv(v, groups), causal=True)
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
