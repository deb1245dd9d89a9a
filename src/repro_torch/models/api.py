"""Model API of the port over every model family (``repro/models/api.py``).

Public surface (used by :mod:`repro_torch.serve.engine` and
:mod:`repro_torch.train.steps`):

* ``param_template(cfg)``      -> nested dict of ParamSpec (no allocation)
* ``init_params(cfg, generator, device)`` -> real params
* ``forward(cfg, params, batch)``               -> (hidden, aux_loss)
* ``loss_fn(cfg, params, batch)``               -> (loss, metrics)
* ``cache_template(cfg, batch, max_seq)``; ``init_cache``
* ``prefill(cfg, params, batch)``               -> (last_logits, cache)
* ``decode_step(cfg, params, tokens, pos, cache)`` -> (logits, cache)

The families are the reference's: ``dense``, ``vlm`` and ``audio`` (the
dense block; the vision front end replaces the first P positions with
projected patches, the audio front end adds projected frames), ``moe``
(attention + :mod:`repro_torch.models.moe`), ``ssm`` (xLSTM: mLSTM /
sLSTM pairs, :mod:`repro_torch.models.xlstm`) and ``hybrid`` (Zamba2:
Mamba2 layers, :mod:`repro_torch.models.mamba2`, with one weight-shared
attention + MLP block after every full group of ``attn_every`` layers).
Layer stacks keep the reference's stacked ``(L, ...)`` layout and are
walked by Python loops over layer views (the reference's ``lax.scan``),
each layer under the remat policy (:func:`_maybe_remat`).  Caches are
nested dicts of stacked tensors (``attn`` k/v, ``mamba`` conv and SSM
state, ``mlstm``/``slstm`` state), written in place by the decode step.

**Prefill attention differs from the reference on purpose.**  The
reference's ``prefill`` runs ``mha(attn_impl="hier")``, a recursive-
halving jnp schedule that XLA needs on the TPU to skip masked FLOPs.  On
the card the counterpart of the reference's attention kernel is the
flash-attention kernel (``csrc/flash_attention.cu``), whose KV loop stops
at the diagonal and so does the same ~S^2/2 work; the port's ``prefill``
therefore calls ``mha(attn_impl="pallas_flash")``: one kernel launch per
attention layer (every layer of the attention families, every shared-
attention call of the hybrid, none in xLSTM).  Both are exact causal
attention and agree within the bf16 tolerance (``tests/test_torch_lm.py``
holds the port against both).

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import ParamSpec, Params

Batch = Dict[str, torch.Tensor]
#: the families whose every layer is attention + an FFN
ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")


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


def _moe_layer_template(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": _norm(cfg.d_model),
        "attn": L.attention_template(cfg),
        "ln2": _norm(cfg.d_model),
        "moe": MOE.moe_template(cfg),
    }


def _xlstm_pair_template(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln_m": _norm(cfg.d_model),
        "mlstm": XL.mlstm_template(cfg),
        "ln_s": _norm(cfg.d_model),
        "slstm": XL.slstm_template(cfg),
    }


def _mamba_layer_template(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": _norm(cfg.d_model), "mamba": M2.mamba2_template(cfg)}


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    t: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": _norm(d),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    if cfg.frontend in ("vision_patches", "audio_frames"):
        t["frontend_proj"] = ParamSpec((cfg.frontend_dim, d), (None, "embed"))

    fam = cfg.family
    if fam in ("dense", "vlm", "audio"):
        t["layers"] = L.stack_template(_dense_layer_template(cfg),
                                       cfg.num_layers)
    elif fam == "moe":
        t["layers"] = L.stack_template(_moe_layer_template(cfg),
                                       cfg.num_layers)
    elif fam == "ssm":  # xLSTM
        assert cfg.num_layers % 2 == 0
        t["layers"] = L.stack_template(_xlstm_pair_template(cfg),
                                       cfg.num_layers // 2)
    elif fam == "hybrid":  # Zamba2
        t["layers"] = L.stack_template(_mamba_layer_template(cfg),
                                       cfg.num_layers)
        t["shared_attn"] = _dense_layer_template(cfg)
    else:
        raise ValueError(f"unknown family {fam!r}")
    return t


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameters' shapes and types on ``meta``: nothing allocated."""
    return L.abstract_from_template(param_template(cfg))


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


def _frontend(feats: torch.Tensor, proj: torch.Tensor, dtype):
    """(B, P, F) patch or frame embeddings through the (F, E) projector
    in their promoted type (jnp's einsum promotes), rounded to ``dtype``."""
    t = torch.promote_types(feats.dtype, proj.dtype)
    return (feats.to(t) @ proj.to(t)).to(dtype)


def _embed(cfg: ModelConfig, params: Params, batch: Batch) -> torch.Tensor:
    x = F.embedding(batch["tokens"], params["embed"])
    if cfg.frontend == "vision_patches" and "patches" in batch:
        proj = _frontend(batch["patches"], params["frontend_proj"], x.dtype)
        x = torch.cat([proj, x[:, proj.shape[1]:]], dim=1)
    elif cfg.frontend == "audio_frames" and "frames" in batch:
        x = x + _frontend(batch["frames"], params["frontend_proj"], x.dtype)
    return x


def _lm_head_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # (E, V), a view
    return params["lm_head"]


def _logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, E) @ (E, V) -> (T, V) f32: the products of the operands' own
    values summed in f32 (the reference's ``preferred_element_type``),
    differentiable (the loss)."""
    if h.device.type != "cpu" and h.dtype != torch.float32:
        return _LogitsF32.apply(h, w)       # the card's (and a meta trace's)
    return h.float() @ w.float()


# ---------------------------------------------------------------------------
# Forward (training) and loss
# ---------------------------------------------------------------------------


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block(p, x, cfg, positions, attn_impl):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.mha(p["attn"], h, cfg, positions=positions,
                  attn_impl=attn_impl)
    return _ffn_residual(p, x, cfg)


def _xlstm_pair_block(p, x, cfg, positions, attn_impl):
    h = L.rms_norm(x, p["ln_m"], cfg.rms_eps)
    x = x + XL.mlstm_forward(p["mlstm"], h, cfg)
    h = L.rms_norm(x, p["ln_s"], cfg.rms_eps)
    return x + XL.slstm_forward(p["slstm"], h, cfg), _no_aux(x)


def _mamba_block(p, x, cfg, positions, attn_impl):
    h = L.rms_norm(x, p["ln"], cfg.rms_eps)
    return x + M2.mamba2_forward(p["mamba"], h, cfg), _no_aux(x)


#: a layer of each family: (p, x) -> (x, aux); the MoE layer is the dense
#: one with the MoE FFN in its place (:func:`_ffn_residual`)
_BLOCK_FNS = {
    "dense": _dense_block, "vlm": _dense_block, "audio": _dense_block,
    "moe": _dense_block, "ssm": _xlstm_pair_block, "hybrid": _mamba_block,
}


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


def _hybrid_groups(cfg: ModelConfig) -> List[Tuple[int, int, bool]]:
    """[(start, size, has_attn_after), ...]: the shared attention block
    runs after each full group of ``attn_every`` Mamba2 layers."""
    period = cfg.attn_every or cfg.num_layers
    groups = []
    i = 0
    while i < cfg.num_layers:
        size = min(period, cfg.num_layers - i)
        groups.append((i, size, size == period))
        i += size
    return groups


def num_shared_attn(cfg: ModelConfig) -> int:
    return sum(1 for _, _, a in _hybrid_groups(cfg) if a)


def _stack_depth(cfg: ModelConfig) -> int:
    """Entries of ``params["layers"]``: xLSTM stacks (mLSTM, sLSTM) pairs."""
    return cfg.num_layers // 2 if cfg.family == "ssm" else cfg.num_layers


def forward(cfg: ModelConfig, params: Params, batch: Batch, *,
            remat: str = "full", attn_impl: str = "flash"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (hidden (B,S,E), aux_loss), the aux
    loss summed over the MoE layers (0 for the other families).

    ``attn_impl`` is the attention schedule of every layer: the
    reference's ``"flash"`` (kernel 7 forward, block-recompute backward)
    or ``"chunked"`` (plain torch, autograd through it)."""
    x = _embed(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    block = _maybe_remat(functools.partial(
        _BLOCK_FNS[cfg.family], cfg=cfg, positions=positions,
        attn_impl=attn_impl), remat)
    layers = L.unstack(params["layers"], _stack_depth(cfg))
    aux = _no_aux(x)
    groups = _hybrid_groups(cfg) if cfg.family == "hybrid" \
        else [(0, len(layers), False)]
    for start, size, has_attn in groups:
        for p in layers[start:start + size]:
            x, a = block(p, x)
            aux = aux + a
        if has_attn:
            x, _ = _dense_block(params["shared_attn"], x, cfg, positions,
                                attn_impl)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, aux


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
    "tokens"}); aux is the MoE layers' load-balance loss (0 for the
    other families)."""
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
# KV / state caches
# ---------------------------------------------------------------------------


def cache_template(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: str = "bfloat16") -> Dict[str, Any]:
    """``dtype`` is the activations' type: the attention keys and values
    and the Mamba2 conv inputs are kept in it; recurrent states are f32."""
    fam = cfg.family
    if fam in ATTN_FAMILIES:
        return {"attn": L.stack_template(
            L.attention_cache_template(cfg, batch, max_seq, dtype),
            cfg.num_layers)}
    if fam == "ssm":
        return {
            "mlstm": L.stack_template(XL.mlstm_cache_template(cfg, batch),
                                      cfg.num_layers // 2),
            "slstm": L.stack_template(XL.slstm_cache_template(cfg, batch),
                                      cfg.num_layers // 2),
        }
    if fam == "hybrid":
        return {
            "mamba": L.stack_template(
                M2.mamba2_cache_template(cfg, batch, dtype), cfg.num_layers),
            "attn": L.stack_template(
                L.attention_cache_template(cfg, batch, max_seq, dtype),
                num_shared_attn(cfg)),
        }
    raise ValueError(fam)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: str = "bfloat16") -> Params:
    """The cache's shapes and types on ``meta``: nothing allocated."""
    return L.abstract_from_template(cache_template(cfg, batch, max_seq, dtype))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               dtype: str = "bfloat16") -> Params:
    return L.tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.torch_dtype, device=device),
        cache_template(cfg, batch, max_seq, dtype))


def _store(stack: Params, i: int, new: Params) -> None:
    """Write one layer's state into entry ``i`` of a stacked cache tree."""
    for k, v in stack.items():
        v[i] = new[k]


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _ffn_residual(p, x, cfg):
    """x + the layer's FFN (MLP or MoE) of its second norm -> (x, aux)."""
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    if "mlp" in p:
        return x + _apply_mlp(p["mlp"], h, cfg), _no_aux(x)
    out, aux = MOE.moe_ffn(p["moe"], h, cfg)
    return x + out, aux


def prefill(cfg: ModelConfig, params: Params, batch: Batch, *,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt: -> (f32 logits of the last position (B, V),
    cache).  Attention caches hold the prompt's keys and values at
    positions 0..S-1 of ``(n, B, max_seq, K, D)`` and zeros after (the
    reference's zero padding), in the activations' type; recurrent caches
    hold each layer's state after the prompt."""
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
    fam = cfg.family

    def attn_prefill(p, xx, i):
        h = L.rms_norm(xx, p["ln1"], cfg.rms_eps)
        out, (k, v) = L.mha(p["attn"], h, cfg, positions=positions,
                            attn_impl="pallas_flash", return_kv=True)
        cache["attn"]["k"][i, :, :S] = k
        cache["attn"]["v"][i, :, :S] = v
        return _ffn_residual(p, xx + out, cfg)[0]

    if fam in ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            x = attn_prefill(L.layer(params["layers"], i), x, i)
    elif fam == "ssm":
        for i in range(cfg.num_layers // 2):
            p = L.layer(params["layers"], i)
            h = L.rms_norm(x, p["ln_m"], cfg.rms_eps)
            y, st = XL.mlstm_forward_with_state(p["mlstm"], h, cfg)
            _store(cache["mlstm"], i, st)
            x = x + y
            h = L.rms_norm(x, p["ln_s"], cfg.rms_eps)
            y, st = XL.slstm_forward_with_state(p["slstm"], h, cfg)
            _store(cache["slstm"], i, st)
            x = x + y
    elif fam == "hybrid":
        a = 0
        for start, size, has_attn in _hybrid_groups(cfg):
            for i in range(start, start + size):
                p = L.layer(params["layers"], i)
                h = L.rms_norm(x, p["ln"], cfg.rms_eps)
                y, st = M2.mamba2_forward_with_state(p["mamba"], h, cfg)
                _store(cache["mamba"], i, st)
                x = x + y
            if has_attn:
                x = attn_prefill(params["shared_attn"], x, a)
                a += 1
    else:
        raise ValueError(fam)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x[:, -1], _lm_head_weight(cfg, params)), cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                pos: int, cache: Params) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) int; ``pos`` a Python int (cache
    fill).  -> (f32 logits (B, V), cache), the cache updated in place."""
    x = _embed(cfg, params, {"tokens": tokens})
    fam = cfg.family

    def attn_decode(p, xx, cache_l):
        h = L.rms_norm(xx, p["ln1"], cfg.rms_eps)
        out, _ = L.mha_decode(p["attn"], h, cache_l, cfg, pos=pos)
        return _ffn_residual(p, xx + out, cfg)[0]

    if fam in ATTN_FAMILIES:
        for i in range(cfg.num_layers):
            x = attn_decode(L.layer(params["layers"], i), x,
                            L.layer(cache["attn"], i))
    elif fam == "ssm":
        for i in range(cfg.num_layers // 2):
            p = L.layer(params["layers"], i)
            h = L.rms_norm(x, p["ln_m"], cfg.rms_eps)
            y, st = XL.mlstm_decode(p["mlstm"], h,
                                    L.layer(cache["mlstm"], i), cfg)
            _store(cache["mlstm"], i, st)
            x = x + y
            h = L.rms_norm(x, p["ln_s"], cfg.rms_eps)
            y, st = XL.slstm_decode(p["slstm"], h,
                                    L.layer(cache["slstm"], i), cfg)
            _store(cache["slstm"], i, st)
            x = x + y
    elif fam == "hybrid":
        a = 0
        for start, size, has_attn in _hybrid_groups(cfg):
            for i in range(start, start + size):
                p = L.layer(params["layers"], i)
                h = L.rms_norm(x, p["ln"], cfg.rms_eps)
                y, st = M2.mamba2_decode(p["mamba"], h,
                                         L.layer(cache["mamba"], i), cfg)
                _store(cache["mamba"], i, st)
                x = x + y
            if has_attn:
                x = attn_decode(params["shared_attn"], x,
                                L.layer(cache["attn"], a))
                a += 1
    else:
        raise ValueError(fam)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x[:, -1], _lm_head_weight(cfg, params)), cache
