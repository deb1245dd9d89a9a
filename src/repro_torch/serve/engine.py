"""Serving steps: batched prefill and single-token decode with KV caches
(port of ``repro/serve/engine.py``).

The reference jits its decode step and donates the cache; here the step
runs eagerly and updates the cache in place (:func:`repro_torch.models.
layers.mha_decode`).  ``pos`` stays a Python int and the next token stays
on the device, so the decode loop makes no host sync per step.  There is
no ``MeshContext`` argument: the port runs on one card until ``dist`` is
ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import api as model_api
from repro_torch.obs.trace import NULL_TRACER, active

Params = Any


def make_prefill_step(run: RunConfig, *, max_seq: int, tracer=NULL_TRACER):
    """-> ``prefill_step(params, batch)``; each call is the ``tracer``'s
    span ``serve.prefill``, with ``tracer`` active (the layers' spans)."""
    cfg = run.model

    def prefill_step(params, batch):
        with active(tracer), tracer.span("serve.prefill"):
            return model_api.prefill(cfg, params, batch, max_seq=max_seq)
    return prefill_step


def make_decode_step(run: RunConfig):
    cfg = run.model

    def decode_step(params, tokens, pos: int, cache):
        logits, cache = model_api.decode_step(cfg, params, tokens, pos, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache
    return decode_step


def greedy_generate(run: RunConfig, params, prompt: torch.Tensor, *,
                    steps: int, max_seq: int, extra=None) -> torch.Tensor:
    """Prefill + ``steps - 1`` decode steps: -> (B, steps) int32 tokens,
    the first from the prefill's logits.  ``extra``: more inputs of the
    prefill's batch (an audio model's ``frames``, a vision model's
    ``patches``); decode steps take tokens only, as the reference's."""
    B, S = prompt.shape
    if S + steps - 1 > max_seq:
        raise ValueError(f"{steps} tokens after a {S}-token prompt need "
                         f"max_seq >= {S + steps - 1}, got {max_seq}")
    logits, cache = make_prefill_step(run, max_seq=max_seq)(
        params, {"tokens": prompt, **(extra or {})})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    decode = make_decode_step(run)
    for pos in range(S, S + steps - 1):
        tok, _, cache = decode(params, tok, pos, cache)
        out.append(tok)
    return torch.cat(out, dim=1)
