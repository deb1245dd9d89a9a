"""Optimizers (pure functional, optax-style), port of
``repro/optim/optimizers.py``.

Three optimizers over the same nested-dict trees as the reference:

* ``adamw``     — f32 m/v;
* ``adafactor`` — factored second moments over the last two axes (of the
  stacked ``(L, ...)`` leaves too), no momentum;
* ``sgdm``      — bf16 momentum, cheapest state.

``init(params) -> state`` and ``update(grads, state, params, step) ->
(params, state)`` build new tensors and never write into their inputs,
so a caller's copy of an earlier state (the trainer's step-0 snapshot)
stays what it was.  Gradients keep their type through clipping (bf16
gradients of bf16 parameters stay bf16) and each update upcasts a leaf
at a time, as the reference does; the step-dependent scalars (the
schedule, the bias corrections) are f32 computed from the integer step.

The reference's ZeRO sharding of the state (``opt_state_shardings``,
``_zero_shard``) places state on many devices; the port runs on one
card, where it has no counterpart (ROADMAP, "Deliberately not ported").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.schedules import warmup_cosine

Params = Any
f32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params, int], Tuple[Params, Params]]
    cfg: OptimizerConfig


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """Leaves of a nested dict in the reference's flatten order (keys
    sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of the nested dict ``tree`` and what sits at
    the same place in each of ``rest`` (a leaf, or a subtree where
    ``tree`` has a leaf: the reference's ``flatten_up_to``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def _unzip(tree: Params, n: int) -> Tuple[Params, ...]:
    """A nested dict with n-tuples at its leaves -> n nested dicts."""
    if isinstance(tree, tuple):
        return tree
    parts = {k: _unzip(tree[k], n) for k in tree}
    return tuple({k: parts[k][i] for k in parts} for i in range(n))


def _scalar(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=f32)


def _global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def _clip_scale(grads, max_norm: float):
    """-> (the factor that clips ``grads`` to ``max_norm``, their global
    norm)."""
    norm = _global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _clip_by_global_norm(grads, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
    # the grads keep their type: an f32 copy of the whole tree would
    # double gradient memory; updates upcast per leaf instead
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


#: the elements of one slab of :func:`_slabbed`: 2^24, 64 MB in f32
SLAB_ELEMENTS = 1 << 24


def _slabbed(fn, *leaves):
    """``fn`` (elementwise: each output element depends on the same
    element of its inputs alone) over the leaves, a slab of whole rows of
    their first axis at a time (at most :data:`SLAB_ELEMENTS`, one row at
    least), into outputs allocated once: the same values as ``fn(*leaves)``
    with f32 temporaries of one slab, not of the leaf (a stacked leaf of
    musicgen-large's MLP is 805 M elements, 3.2 GB in f32)."""
    first = leaves[0]
    if first.dim() == 0 or first.numel() <= SLAB_ELEMENTS:
        return fn(*leaves)
    rows = max(1, SLAB_ELEMENTS // (first.numel() // first.shape[0]))
    outs = None
    for i in range(0, first.shape[0], rows):
        got = fn(*(t[i:i + rows] for t in leaves))
        if outs is None:
            outs = tuple(torch.empty(first.shape, dtype=o.dtype,
                                     device=o.device) for o in got)
        for o, g in zip(outs, got):
            o[i:i + rows] = g
    return outs


def _lr(ocfg: OptimizerConfig, step: int) -> torch.Tensor:
    return warmup_cosine(step, peak_lr=ocfg.lr,
                         warmup_steps=ocfg.warmup_steps)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw(ocfg: OptimizerConfig) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=f32,  # noqa: E731
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        # clipped leaf by leaf inside the update (the same bf16 product as
        # _clip_by_global_norm's), a slab at a time: no clipped copy of
        # the gradients and no leaf-sized f32 temporaries beside the new
        # parameters and moments (musicgen-large's full step fits one
        # card so)
        scale, _ = _clip_scale(grads, ocfg.grad_clip)
        lr = _lr(ocfg, step)
        b1, b2 = ocfg.beta1, ocfg.beta2
        t = _scalar(step) + 1.0
        corr1 = 1.0 - _scalar(b1) ** t
        corr2 = 1.0 - _scalar(b2) ** t

        def upd_slab(g, m, v, p):
            g = (g * scale.to(g.dtype)).float()
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g.square()
            step_ = (m2 / corr1) / (torch.sqrt(v2 / corr2) + ocfg.eps)
            step_ = step_ + ocfg.weight_decay * p.float()
            newp = (p.float() - lr * step_).to(p.dtype)
            return newp, m2, v2

        def upd(g, m, v, p):
            return _slabbed(upd_slab, g, m, v, p)

        newp, m, v = _unzip(tree_map(upd, grads, state["m"], state["v"],
                                     params), 3)
        return newp, {"m": m, "v": v}

    return Optimizer("adamw", init, update, ocfg)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _adafactor(ocfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def state_for(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=f32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=f32, device=p.device)}
        return {"f": tree_map(state_for, params)}

    def update(grads, state, params, step):
        grads, _ = _clip_by_global_norm(grads, ocfg.grad_clip)
        lr = _lr(ocfg, step)
        t = _scalar(step) + 1.0
        beta2 = 1.0 - t ** -0.8                      # Adafactor's schedule
        eps = 1e-30

        def upd(g, s, p):
            g = g.float()
            g2 = g.square() + eps
            if _factored(p):
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                rms = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps))
                news = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                rms = torch.sqrt(v)
                news = {"v": v}
            step_ = g / torch.clamp(rms, min=1e-12)
            # relative step clipping (RMS-capped update)
            d = step_ / torch.clamp(torch.sqrt(step_.square().mean()),
                                    min=1.0)
            d = d + ocfg.weight_decay * p.float()
            newp = (p.float() - lr * d).to(p.dtype)
            return newp, news

        newp, news = _unzip(tree_map(upd, grads, state["f"], params), 2)
        return newp, {"f": news}

    return Optimizer("adafactor", init, update, ocfg)


# ---------------------------------------------------------------------------
# SGD + momentum (bf16 state)
# ---------------------------------------------------------------------------


def _sgdm(ocfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"mom": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params)}

    def update(grads, state, params, step):
        grads, _ = _clip_by_global_norm(grads, ocfg.grad_clip)
        lr = _lr(ocfg, step)

        def upd(g, m, p):
            m2 = ocfg.beta1 * m.float() + g.float()
            newp = (p.float() - lr * m2).to(p.dtype)
            return newp, m2.to(torch.bfloat16)

        newp, mom = _unzip(tree_map(upd, grads, state["mom"], params), 2)
        return newp, {"mom": mom}

    return Optimizer("sgdm", init, update, ocfg)


_MAKERS = {"adamw": _adamw, "adafactor": _adafactor, "sgdm": _sgdm}


def make_optimizer(ocfg: OptimizerConfig) -> Optimizer:
    return _MAKERS[ocfg.name](ocfg)
