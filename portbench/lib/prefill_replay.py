"""The sealed-prefill driver for a model whose MoE routes each token to
its top-k experts, with the program's expert choices replayed in the
reference.

The window, its traffic, its timing and its spans are the prefill
driver's (``lib/prefill.py``: its ``drive`` runs with this module's
:func:`judge` in its own one's place for the call).  The check differs.
With random weights a token whose (k)th and (k+1)th router scores lie
within rounding of each other picks another expert in bf16 than the f32
reference does; its output then moves by a whole expert's share, the
next layers' routing sees that, and at Moonlight's depth the last logits
of the two sides end up unrelated (``PERF.md`` §2: sound runs and the
fp8 control alike read ``logits_rel_l2`` 0.8-1.1).  So the reference
takes the program's choices: each sampled request's batch is prefilled
once more after the window, through the same serving path, with the
program's router (``repro_torch.models.moe.route_sigmoid``) recorded; the
replay must give the served logits bit for bit (else the choices are
not those the timed path made, and the readings are infinite: not
correct); the family module's ``last_logits`` then runs with
``choices=`` those expert ids, and its weights its own f32 scores of
them.  The fp8 control replays the same choices, so the two sides differ
in the rounding of every product and in nothing else.

The choices are data the program made, so they are judged too: as the
reference replays them it scores each MoE layer's experts on its own
hidden state, and ``routing_misses`` is the share of the program's
chosen experts whose biased score lies below the reference's (k)th by
more than a rounding margin (the family module's ``CHOICE_MARGIN``): a
router that drops the correction bias, sorts the wrong way or takes
another k reads far above the near-tie flips of a sound one
(``routing_flips``, below the (k)th by any amount, is printed).  The
control replays the program's choices, so it reads the program's
number here and is told apart by its logits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from portbench.lib import check, port, spec
from portbench.lib import prefill as base

END_TO_END = base.END_TO_END
CONTROLS = base.CONTROLS

Choices = Dict[Tuple[int, int], List[torch.Tensor]]


def drive(name: str, cfg: dict, traffic: dict, *, seed: int, seconds: float,
          trace: bool, device, control: Optional[str] = None) -> dict:
    own = base.judge
    base.judge = lambda *a, **kw: judge(name, *a, **kw)
    try:
        return base.drive(name, cfg, traffic, seed=seed, seconds=seconds,
                          trace=trace, device=device, control=control)
    finally:
        base.judge = own


def judge(name, m, T, seed, weights, kept, device, control=None):
    """The prefill driver's readings (the sealed round trip, the served
    token's gap and the logits' relative L2 distance, each the widest of
    the sample) against the reference with the program's expert choices
    replayed, and the share of those choices that miss the reference's
    own top-k beyond rounding; with ``control``, the control's logits and
    tokens, under the same choices, in the program's place."""
    mismatches = sum(
        int(not torch.equal(opened, spec.prompts(m, seed, i, T // S, S,
                                                 device)))
        for i, (S, opened, _, _) in enumerate(kept))
    sample = base.sample_of(T, [S for S, *_ in kept], seed)
    choices, unreplayed = program_choices(name, m, weights, kept, sample)
    misses: List[tuple] = []
    ref = reference_logits(m, T, seed, weights, sample, choices, device,
                           misses=misses)
    flips, beyond, given = (sum(c) for c in zip(*misses))
    if control is None:
        logits = torch.stack([kept[i][2][r] for i, r, _ in sample])
        tokens = torch.stack([kept[i][3][r] for i, r, _ in sample])
    else:
        logits = reference_logits(m, T, seed, weights, sample, choices,
                                  device, fp8=True)
        tokens = logits.argmax(dim=-1)
    gaps, rels = check.logit_numbers(logits, tokens, ref)
    worst = math.inf if unreplayed else 0.0
    return ({"roundtrip_mismatches": float(mismatches),
             "logit_gap": max(max(gaps), worst),
             "logits_rel_l2": max(max(rels), worst),
             "routing_misses": max(beyond / given, worst)},
            {"sampled_requests": len(sample),
             "routing_flips": flips / given,
             "sampled_tokens": sum(s for _, _, s in sample),
             "longest": max(s for _, _, s in sample),
             "unreplayed_batches": unreplayed})


def program_choices(name, m, weights, kept, sample) -> Tuple[Choices, int]:
    """Each sampled request's expert ids, a (S, k) tensor a MoE layer in
    order, from a second prefill of its batch through the serving path
    with the program's router recorded -> (choices by (batch, row), the
    batches whose second prefill did not give the served logits bit for
    bit)."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import moe as program_moe
    from repro_torch.serve import engine
    cfg = port.model_config(name, m)
    run = RunConfig(model=cfg, shape=ShapeConfig("portbench", 0, 0,
                                                 "prefill"))
    want = (cfg.num_layers - cfg.first_dense_layers, cfg.moe.top_k)
    real = program_moe.route_sigmoid
    out: Choices = {}
    unreplayed = 0
    for i in sorted({b for b, _, _ in sample}):
        S, opened, served, _ = kept[i]
        layers: List[torch.Tensor] = []

        def recording(*args, **kwargs):
            topw, topi = real(*args, **kwargs)
            layers.append(topi)
            return topw, topi
        program_moe.route_sigmoid = recording
        try:
            with torch.no_grad():
                again, cache = engine.make_prefill_step(run, max_seq=S)(
                    weights, {"tokens": opened})
            del cache
        finally:
            program_moe.route_sigmoid = real
        unreplayed += int(not torch.equal(again, served))
        B = opened.shape[0]
        seen = (len(layers), {tuple(t.shape) for t in layers})
        if seen != (want[0], {(B * S, want[1])}):
            raise RuntimeError(
                f"recorded {seen[0]} router calls of shapes {seen[1]} in "
                f"a prefill of {B} x {S}, not {want[0]} of ({B * S}, "
                f"{want[1]}): the program no longer chooses its experts in "
                "repro_torch.models.moe.route_sigmoid, where the choices "
                "are recorded")
        for b, r, _ in sample:
            if b == i:
                out[(b, r)] = [t.view(B, S, -1)[r] for t in layers]
        del layers
    return out, unreplayed


def reference_logits(m, T, seed, weights, sample, choices: Choices, device,
                     fp8=False, misses=None):
    """The reference's last logits of each sampled request, in order, with
    its expert choices replayed and checked into ``misses``; the requests
    of one length in one call."""
    last_logits = spec.family(m).last_logits
    out = [None] * len(sample)
    for S in sorted({s for _, _, s in sample}, reverse=True):
        idx = [j for j, (_, _, s) in enumerate(sample) if s == S]
        toks = torch.cat([spec.prompts(m, seed, sample[j][0], T // S, S,
                                       device)[sample[j][1]][None]
                          for j in idx])
        keys = [sample[j][:2] for j in idx]
        layers = len(choices[keys[0]])
        replay = [torch.stack([choices[key][n] for key in keys])
                  for n in range(layers)]
        logits = last_logits(m, weights, toks, fp8=fp8, choices=replay,
                             misses=misses)
        for k, j in enumerate(idx):
            out[j] = logits[k]
    return torch.stack(out)
