"""Model API of the port for the dense family (``repro/models/api.py``).

Public surface (used by :mod:`repro_torch.serve.engine` and
:mod:`repro_torch.train.steps`):

* ``param_template(cfg)``      -> nested dict of ParamSpec (no allocation)
* ``init_params(cfg, generator, device)`` -> real params
* ``forward(cfg, params, batch)``               -> (hidden, aux_loss)
* ``loss_fn(cfg, params, batch)``               -> (loss, metrics)
* ``cache_template(cfg, batch, max_seq)``; ``init_cache``
* ``prefill(cfg, params, batch)``               -> (last_logits, cache)
* ``decode_step(cfg, params, tokens, pos, cache)`` -> (logits, cache)

Only ``family="dense"`` is ported; ``moe``, ``ssm``, ``hybrid``, ``vlm``
and ``audio`` raise ``NotImplementedError`` (ROADMAP Queue 1 item 7).
The layer stack keeps the reference's stacked ``(L, ...)`` layout and is
walked by a Python loop over layer views (the reference's ``lax.scan``),
each layer under the remat policy (:func:`_maybe_remat`).

**Prefill attention differs from the reference on purpose.**  The
reference's ``prefill`` runs ``mha(attn_impl="hier")``, a recursive-
halving jnp schedule that XLA needs on the TPU to skip masked FLOPs.  On
the card the counterpart of the reference's attention kernel is the
flash-attention kernel (``csrc/flash_attention.cu``), whose KV loop stops
at the diagonal and so does the same ~S^2/2 work; the port's ``prefill``
therefore calls ``mha(attn_impl="pallas_flash")``: one kernel launch per
layer.  Both are exact causal attention and agree within the bf16
tolerance (``tests/test_torch_lm.py`` holds the port against both).

**Logits in f32 from bf16 operands.**  The reference's LM head is an
einsum with ``preferred_element_type=f32``: exact bf16 products summed
and returned in f32.  A bf16 ``torch.matmul`` would round the logits to
bf16 and could flip a greedy argmax.  On the card the head is
``torch.mm(h, W, out_dtype=torch.float32)``: cuBLAS reads the bf16
weight as it is (no f32 copy of the 128,256 x 2048 tied embedding, which
would be 1 GB of traffic a decode step) and writes f32.  The CPU has no
such overload, so there the (small) operands are cast to f32 first; both
compute the same function.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec, Params

Batch = Dict[str, torch.Tensor]
PORTED_FAMILIES = ("dense",)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 7); ported: {PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def _mlp_template(cfg: ModelConfig) -> Dict[str, Any]:
    t = {
        "wu": ParamSpec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
        "wd": ParamSpec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
    }
    if cfg.mlp_type == "swiglu":
        t["wg"] = ParamSpec((cfg.d_model, cfg.d_ff), ("embed", "mlp"))
    return t


def _apply_mlp(p, h, cfg):
    if cfg.mlp_type == "swiglu":
        return L.swiglu(h, p["wg"], p["wu"], p["wd"])
    u = h @ p["wu"]
    u = F.gelu(u.float(), approximate="tanh").to(h.dtype)   # jax.nn.gelu
    return u @ p["wd"]


def _dense_layer_template(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": _norm(cfg.d_model),
        "attn": L.attention_template(cfg),
        "ln2": _norm(cfg.d_model),
        "mlp": _mlp_template(cfg),
    }


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    t: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm(d),
        "layers": L.stack_template(_dense_layer_template(cfg),
                                   cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights drawn from ``generator`` (on ``device``)."""
    return L.init_from_template(param_template(cfg), generator, device)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


class _LogitsF32(torch.autograd.Function):
    """:func:`_logits` on the card: ``torch.mm``'s ``out_dtype`` overload
    (no f32 copy of the weight) has no derivative.  The backward rounds
    the f32 cotangent to the operands' type and runs both products on
    the tensor cores (an f32 product of the (T, V) cotangent would take
    ~30x as long); the CPU path differentiates the f32 product exactly."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return g @ w.T, h.T @ g


def _embed(cfg: ModelConfig, params: Params, batch: Batch) -> torch.Tensor:
    return F.embedding(batch["tokens"], params["embed"])


def _lm_head_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # (E, V), a view
    return params["lm_head"]


def _logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, E) @ (E, V) -> (T, V) f32: the products of the operands' own
    values summed in f32 (the reference's ``preferred_element_type``),
    differentiable (the loss)."""
    if h.is_cuda and h.dtype != torch.float32:
        return _LogitsF32.apply(h, w)
    return h.float() @ w.float()


# ---------------------------------------------------------------------------
# Forward (training) and loss
# ---------------------------------------------------------------------------


def _dense_block(p, x, cfg, positions, attn_impl):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.mha(p["attn"], h, cfg, positions=positions,
                  attn_impl=attn_impl)
    return _dense_mlp_residual(p, x, cfg)


#: the ops whose results "selective" remat keeps: the products with no
#: batch dimension (``dots_with_no_batch_dims_saveable``), i.e. the
#: activations times a weight matrix; attention's batched products and
#: everything elementwise are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """``"none"``: ``fn``; ``"full"``: ``fn`` under
    ``torch.utils.checkpoint`` (its inputs kept, everything else
    recomputed in the backward); ``"selective"``: the same, but the
    non-batched matrix products' results are kept.  Remat changes memory
    only: the recompute runs the same ops on the same inputs."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "selective":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _selective_policy))
    raise ValueError(f"unknown remat {remat!r}")


def forward(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: str = "full", attn_impl: str = "flash"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (hidden (B,S,E), aux_loss).

    ``attn_impl`` is the attention schedule of every layer: the
    reference's ``"flash"`` (kernel 7 forward, block-recompute backward)
    or ``"chunked"`` (plain torch, autograd through it)."""
    _require_ported(cfg)
    x = _embed(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    block = _maybe_remat(functools.partial(
        _dense_block, cfg=cfg, positions=positions, attn_impl=attn_impl),
        remat)
    for p in L.unstack(params["layers"], cfg.num_layers):
        x = block(p, x)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _chunk_loss(hx: torch.Tensor, lx: torch.Tensor, w: torch.Tensor):
    logits = _logits(hx, w)                            # (T, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, lx.clamp_min(0)[:, None].long())[:, 0]
    valid = (lx >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def loss_fn(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: str = "full", loss_chunks: int = 8,
            aux_weight: float = 0.01, attn_impl: str = "flash"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over labels >= 0 (-1 = ignored), through a
    streaming LM head: the (T, V) logits exist one of ``loss_chunks``
    chunks at a time, f32 from the bf16 operands, each chunk under the
    remat policy.  -> (loss + aux_weight * aux, {"loss", "aux",
    "tokens"}); aux is 0 for the dense family."""
    hidden, aux = forward(cfg, params, batch, remat=remat,
                          attn_impl=attn_impl)
    B, S, E = hidden.shape
    W = _lm_head_weight(cfg, params)
    labels = batch["labels"].reshape(B * S)
    h = hidden.reshape(B * S, E)
    nchunk = loss_chunks
    while (B * S) % nchunk:
        nchunk -= 1
    T = (B * S) // nchunk
    body = _maybe_remat(_chunk_loss, remat)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    ntok = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nchunk):
        n, t = body(h[c * T:(c + 1) * T], labels[c * T:(c + 1) * T], W)
        nll, ntok = nll + n, ntok + t
    loss = nll / ntok.clamp_min(1.0)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": ntok}


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def cache_template(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: str = "bfloat16") -> Dict[str, Any]:
    _require_ported(cfg)
    return {"attn": L.stack_template(
        L.attention_cache_template(cfg, batch, max_seq, dtype),
        cfg.num_layers)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               dtype: str = "bfloat16") -> Params:
    return L.tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.torch_dtype, device=device),
        cache_template(cfg, batch, max_seq, dtype))


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _dense_mlp_residual(p, x, cfg):
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + _apply_mlp(p["mlp"], h, cfg)


def prefill(cfg: ModelConfig, params: Params, batch: Batch, *,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt: -> (f32 logits of the last position (B, V),
    cache).  The cache holds the prompt's keys and values at positions
    0..S-1 of ``(L, B, max_seq, K, D)`` and zeros after (the reference's
    zero padding), in the activations' type."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} < prompt length {S}")
    x = _embed(cfg, params, batch)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_seq, x.device,
                       str(x.dtype).removeprefix("torch."))
    for i in range(cfg.num_layers):
        p = L.layer(params["layers"], i)
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        out, (k, v) = L.mha(p["attn"], h, cfg, positions=positions,
                            attn_impl="pallas_flash", return_kv=True)
        x = _dense_mlp_residual(p, x + out, cfg)
        cache["attn"]["k"][i, :, :S] = k
        cache["attn"]["v"][i, :, :S] = v
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x[:, -1], _lm_head_weight(cfg, params)), cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                pos: int, cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) int; ``pos`` a Python int (cache
    fill).  -> (f32 logits (B, V), cache), the cache updated in place."""
    _require_ported(cfg)
    x = _embed(cfg, params, {"tokens": tokens})
    for i in range(cfg.num_layers):
        p = L.layer(params["layers"], i)
        h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
        out, _ = L.mha_decode(p["attn"], h, L.layer(cache["attn"], i), cfg,
                              pos=pos)
        x = _dense_mlp_residual(p, x + out, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x[:, -1], _lm_head_weight(cfg, params)), cache
