"""Training / eval step factories (port of ``repro/train/steps.py``).

``make_train_step`` returns a function
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``.
Gradients are ``torch.autograd.grad`` of
:func:`repro_torch.models.api.loss_fn` over the parameter leaves (the
reference's ``value_and_grad``): in the parameters' type, bf16 for bf16
parameters.  With ``run.microbatches > 1`` the batch is split along its
first axis and the microbatches' gradients are summed in f32 and
averaged (the reference's inner ``lax.scan``); ``grad_compression ==
"fp16"`` rounds the gradients through float16.  The step is eager: there
is no ``jit`` and nothing to donate; the optimizer returns new tensors.

There is no ``MeshContext`` argument, as in :mod:`repro_torch.serve.
engine`: the port trains on one card, and the reference's
``train_input_shardings`` (the batch's ``NamedSharding``s) has no
counterpart there (ROADMAP, "Deliberately not ported").
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import api as model_api
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import Optimizer, tree_leaves, tree_map

Params = Any
Batch = Dict[str, torch.Tensor]


def _split_microbatches(batch: Batch, n: int):
    def split(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch of {B} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, B // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(run: RunConfig, *, attn_impl: str = "flash"
                    ) -> Tuple[Any, Optimizer]:
    """-> (train_step, optimizer).  ``attn_impl`` is the attention of
    every layer (:func:`repro_torch.models.api.forward`)."""
    cfg = run.model
    opt = make_optimizer(run.optimizer)
    nmb = run.microbatches

    def loss_and_grads(params, batch):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(live)
        loss, metrics = model_api.loss_fn(
            cfg, tree_map(lambda _: next(it), params), batch,
            remat=run.remat, attn_impl=attn_impl)
        grads = iter(torch.autograd.grad(loss, live))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(grads), params))

    def train_step(params, opt_state, batch, step: int):
        if nmb == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for mbatch in _split_microbatches(batch, nmb):
                l, _, g = loss_and_grads(params, mbatch)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / nmb, grads)
            loss = loss / nmb
            metrics = {"loss": loss}
        if run.optimizer.grad_compression == "fp16":
            grads = tree_map(lambda g: g.to(torch.float16).float(), grads)
        new_params, new_state = opt.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics["step"] = torch.tensor(step, dtype=torch.float32)
        return new_params, new_state, metrics

    return train_step, opt


def make_eval_step(run: RunConfig):
    cfg = run.model

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model_api.loss_fn(cfg, params, batch, remat="none")
        return metrics
    return eval_step
