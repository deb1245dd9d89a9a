"""Named terminal reducers on device tensors (port of
``repro/dsl/reducers.py``).

Each registration is a *factory* returning a fresh ``(fn, init)`` pair
per pipeline build; ``device`` says where the accumulators live (the
pipeline's device).  Built-ins:

* ``carrier_delay_stats`` — the paper's DelayedFlights benchmark (§5.2):
  per-carrier delayed-flight counts + delay sums over packed records
  (word 0 = carrier, word 1 = delay minutes), accumulated in float64 on
  the device with ``torch.bincount`` (integers below 2^53 add exactly,
  so the result equals the reference's numpy fold bit for bit).
* ``sum`` — elementwise running sum of chunks (the 8-stage job's fold).
* ``count`` — number of chunks that reached the sink.

Register your own::

    from repro_torch.dsl import register_reducer

    @register_reducer("my_stats")
    def _my_stats(**kw):
        def fn(acc, chunk): ...
        return fn, init

A factory that takes a ``device`` keyword gets the pipeline's device
from the DSL compiler (:func:`resolve_reducer_on`).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.data.synthetic import CARRIER_WORD, DELAY_WORD
from repro_torch.u32 import lift

ReducerFactory = Callable[..., Tuple[Callable, Any]]

REDUCERS: Dict[str, ReducerFactory] = {}


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
    def fn(acc, chunk):
        carrier = lift(chunk[:, CARRIER_WORD])
        delay = lift(chunk[:, DELAY_WORD])
        # rows with delay 0 weigh 0: no boolean mask, so no data-dependent
        # shape on the device
        valid = (delay > 0).to(torch.float64)
        acc["count"] = acc["count"] + torch.bincount(
            carrier, weights=valid, minlength=num_carriers)
        acc["sum"] = acc["sum"] + torch.bincount(
            carrier, weights=delay.to(torch.float64) * valid,
            minlength=num_carriers)
        return acc
    zeros = torch.zeros(num_carriers, dtype=torch.float64, device=device)
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
