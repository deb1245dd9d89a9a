"""The trip-count marker: a model runs a loop whose body repeats through
:func:`scan`, which states that every trip does the same work.

Outside an analysis ``scan`` is the plain loop.  An analysis that counts
a step without running every trip (``launch.analysis.analyze(...,
scale_loops=True)``) pushes a scaler onto :data:`SCALERS` while it runs;
``scan`` then hands its loop to the innermost one.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

#: ``scaler(body, carry, steps, consts, trips, keep, name)`` of the
#: analyses running, the innermost last; each returns what :func:`scan`
#: returns
SCALERS: List[Callable] = []


def scan(body: Callable, carry: Dict[str, torch.Tensor],
         xs: Dict[str, torch.Tensor], consts: Dict[str, torch.Tensor], *,
         keep: str, name: str):
    """The loop ``carry = body(carry, x_t, consts)`` for t < T, where x_t
    holds each of ``xs``' (B, T, ...) tensors at step t (one ``unbind``
    each, whose backward is one stack) and ``consts`` the tensors every
    trip reads (weights).  -> (the last carry, [carry[keep] after each
    trip]).  Under a scaler a loop of more than two trips is the scaler's
    to run, and ``name`` names it in the scaler's records."""
    steps = {k: v.unbind(1) for k, v in xs.items()}
    trips = len(next(iter(steps.values())))
    if SCALERS and trips > 2:
        return SCALERS[-1](body, carry, steps, consts, trips, keep, name)
    kept = []
    for t in range(trips):
        carry = body(carry, {k: s[t] for k, s in steps.items()}, consts)
        kept.append(carry[keep])
    return carry, kept
