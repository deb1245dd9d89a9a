"""Named terminal reducers on device tensors (port of
``repro/dsl/reducers.py``).

Each registration is a *factory* returning a fresh ``(fn, init)`` pair
per pipeline build; ``device`` says where the accumulators live (the
pipeline's device).  Built-ins:

* ``carrier_delay_stats`` — the paper's DelayedFlights benchmark (§5.2):
  per-carrier delayed-flight counts + delay sums over packed records
  (word 0 = carrier, word 1 = delay minutes), folded in float64 on the
  device with one ``index_add_`` a chunk into fixed-size bins (integers
  below 2^53 add exactly in any order, so the result equals the
  reference's numpy fold bit for bit), without a host sync.
* ``sum`` — elementwise running sum of chunks (the 8-stage job's fold).
* ``count`` — number of chunks that reached the sink.

Register your own::

    from repro_torch.dsl import register_reducer

    @register_reducer("my_stats")
    def _my_stats(**kw):
        def fn(acc, chunk): ...
        return fn, init

A factory that takes a ``device`` keyword gets the pipeline's device
from the DSL compiler (:func:`resolve_reducer_on`).  A ``fn`` may carry
a ``finish(acc) -> result`` attribute: ``Pipeline.run`` (both engines)
and ``Observable.subscribe`` call it once on the terminal state, so a
check that needs the host runs once a run instead of once a chunk.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.data.synthetic import CARRIER_WORD, DELAY_WORD
from repro_torch.u32 import lift

ReducerFactory = Callable[..., Tuple[Callable, Any]]

REDUCERS: Dict[str, ReducerFactory] = {}

#: carrier_delay_stats' private accumulator (its ``finish`` returns the
#: reference's ``{"count", "sum"}``)
BINS = "_bins"


def register_reducer(name: str) -> Callable[[ReducerFactory],
                                            ReducerFactory]:
    """Decorator: register a ``(**kw) -> (fn, init)`` reducer factory."""
    def deco(factory: ReducerFactory) -> ReducerFactory:
        REDUCERS[name] = factory
        return factory
    return deco


def reducer_factory(name: str) -> ReducerFactory:
    """The factory registered under ``name``; KeyError naming the
    registered reducers otherwise."""
    factory = REDUCERS.get(name)
    if factory is None:
        raise KeyError(f"unknown reducer {name!r}; registered: "
                       f"{sorted(REDUCERS)} "
                       f"(add one with @register_reducer)")
    return factory


def resolve_reducer(name: str, **kw) -> Tuple[Callable, Any]:
    """Instantiate a registered reducer -> fresh ``(fn, init)``."""
    return reducer_factory(name)(**kw)


def resolve_reducer_on(name: str, device) -> Tuple[Callable, Any]:
    """:func:`resolve_reducer` with ``device`` passed to the factories
    that take it (accumulators on the pipeline's device)."""
    factory = reducer_factory(name)
    params = inspect.signature(factory).parameters
    takes = "device" in params or any(
        p.kind is p.VAR_KEYWORD for p in params.values())
    return factory(device=device) if takes else factory()


@register_reducer("carrier_delay_stats")
def _carrier_delay_stats(num_carriers: int = 20, device="cuda"):
    """Per-carrier delayed count + delay-minute sum (paper §5.2)."""
    nc = num_carriers

    def fn(acc, chunk):
        if BINS not in acc:
            # the first fold: a private accumulator, init left untouched.
            # Row 0 counts, row 1 sums; bin nc takes the delayed records
            # whose carrier is out of range, bin nc + 1 the undelayed ones
            # (the reference folds carrier[delay > 0] only)
            z = acc["count"].new_zeros(2)
            acc = {BINS: torch.stack([torch.cat([acc["count"], z]),
                                      torch.cat([acc["sum"], z])])}
        carrier = lift(chunk[:, CARRIER_WORD]).clamp_(max=nc)
        delay = chunk[:, DELAY_WORD]
        idx = torch.where(delay != 0, carrier, nc + 1)
        # (2, rows): ones over the u32 delays as float64
        w = F.pad(torch.remainder(delay.to(torch.float64), 2.0 ** 32)
                  .unsqueeze(0), (0, 0, 1, 0), value=1.0)
        acc[BINS].index_add_(1, idx, w)
        return acc

    def finish(acc):
        # the reference's fold raises on a delayed carrier >= num_carriers
        # (its histogram outgrows the accumulator): one host sync a run
        bins = acc[BINS]
        bad = int(bins[0, nc])
        if bad:
            raise ValueError(f"carrier_delay_stats: {bad} delayed records "
                             f"carry a carrier >= num_carriers={nc}")
        return {"count": bins[0, :nc], "sum": bins[1, :nc]}
    fn.finish = finish
    zeros = torch.zeros(nc, dtype=torch.float64, device=device)
    return fn, {"count": zeros, "sum": zeros.clone()}


@register_reducer("sum")
def _sum():
    """Elementwise running sum over chunks (None-seeded first fold)."""
    def fn(acc, chunk):
        return chunk if acc is None else acc + chunk
    return fn, None


@register_reducer("count")
def _count():
    """Count of chunks that survived to the sink."""
    return (lambda acc, chunk: acc + 1), 0
