"""Model API of the port for the dense family (``repro/models/api.py``).

Public surface (used by :mod:`repro_torch.serve.engine`):

* ``param_template(cfg)``      -> nested dict of ParamSpec (no allocation)
* ``init_params(cfg, generator, device)`` -> real params
* ``cache_template(cfg, batch, max_seq)``; ``init_cache``
* ``prefill(cfg, params, batch)``               -> (last_logits, cache)
* ``decode_step(cfg, params, tokens, pos, cache)`` -> (logits, cache)

Only ``family="dense"`` is ported; ``moe``, ``ssm``, ``hybrid``, ``vlm``
and ``audio`` raise ``NotImplementedError`` (ROADMAP Queue 1 item 15),
and ``forward`` / ``loss_fn`` come with training.  The layer stack keeps
the reference's stacked ``(L, ...)`` layout and is walked by a Python
loop over layer views (the reference's ``lax.scan``).

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

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec, Params

Batch = Dict[str, torch.Tensor]
PORTED_FAMILIES = ("dense",)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 15); ported: {PORTED_FAMILIES}")


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


def _embed(cfg: ModelConfig, params: Params, batch: Batch) -> torch.Tensor:
    return F.embedding(batch["tokens"], params["embed"])


def _lm_head_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # (E, V), a view
    return params["lm_head"]


def _logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, E) @ (E, V) -> (B, V) f32: the products of the operands' own
    values summed in f32 (the reference's ``preferred_element_type``)."""
    if h.is_cuda:
        return torch.mm(h, w, out_dtype=torch.float32)
    return h.float() @ w.float()


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
