"""Rx-style Observable combinators over chunked tensor streams.

Port of ``repro/core/observable.py`` on torch tensors.  The paper builds
pipelines from RxLua observables (``:map/:filter/:reduce/:subscribe``,
Listing 2).  Here a *stream* is a sequence of fixed-shape chunks (a
tensor or a dict of tensors); each operator is a function over a chunk
(one chunk is the unit of enclave transfer, paper Fig. 4); ``filter`` is
dense (a validity mask), because dataflow on accelerators cannot drop
rows dynamically.

Example (the paper's Listing-2 average-age program)::

    (Observable.from_chunks(people)
        .map(lambda c: c["age"])
        .filter(lambda age: age > 18)
        .reduce(lambda acc, age, m: {"sum": acc["sum"] + (age*m).sum(),
                                     "count": acc["count"] + m.sum()},
                init={"sum": 0.0, "count": 0.0})
        .subscribe(on_next=..., on_complete=...))
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

Chunk = Any  # tensor or dict of tensors


@dataclass(frozen=True)
class Op:
    """One node of an operator chain.

    Shared vocabulary between this cleartext Observable layer and the
    secure-pipeline DSL (:mod:`repro_torch.dsl.builder`): the DSL's
    fluent chain is a tuple of these same nodes, with ``meta`` carrying
    the paper's Listing-1 stage attributes (``name``, ``workers``,
    ``sgx`` placement, static ``op``/``const``).  ``describe_ops``
    renders either chain identically; ``StreamBuilder.as_observable``
    lowers a DSL chain back onto an Observable (the cleartext oracle).
    """
    kind: str                     # map | filter | reduce | window | key_by
    fn: Optional[Callable] = None
    init: Any = None
    meta: Dict[str, Any] = field(default_factory=dict)


def describe_ops(ops: Tuple[Op, ...]) -> str:
    """One-line summary of an op chain — ``map(identity)[w=4,sgx] ->
    filter(delay_filter_u32) -> reduce`` — shared by
    :meth:`Observable.describe` and ``StreamBuilder.describe``."""
    parts = []
    for o in ops:
        name = o.meta.get("op") or getattr(o.fn, "__name__", None) \
            or o.meta.get("reducer") or ""
        label = f"{o.kind}({name})" if name and name != "<lambda>" \
            else o.kind
        attrs = []
        if o.meta.get("workers", 1) != 1:
            attrs.append(f"w={o.meta['workers']}")
        if o.meta.get("sgx"):
            attrs.append("sgx")
        if attrs:
            label += f"[{','.join(attrs)}]"
        parts.append(label)
    return " -> ".join(parts) if parts else "(empty)"


def _concat(chunks):
    """Concatenate same-structure chunks leaf by leaf (tensors, or dicts,
    lists and tuples of them) along their first axis."""
    first = chunks[0]
    if isinstance(first, dict):
        return {k: _concat([c[k] for c in chunks]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat(list(leaves)) for leaves in zip(*chunks))
    return torch.cat(list(chunks))


class Observable:
    """A lazily-composed operator chain over a chunk source."""

    def __init__(self, source: Iterable[Chunk], ops: Tuple[Op, ...] = ()):
        self._source = source
        self._ops = ops

    # ---------------------------------------------------------- constructors

    @staticmethod
    def from_chunks(chunks: Iterable[Chunk]) -> "Observable":
        return Observable(chunks)

    @staticmethod
    def from_array(x, chunk_rows: int) -> "Observable":
        n_full, rem = divmod(x.shape[0], chunk_rows)

        def gen():
            for i in range(n_full):
                yield x[i * chunk_rows:(i + 1) * chunk_rows]
            if rem:  # ragged tail chunk — rows must not be dropped
                yield x[n_full * chunk_rows:]
        return Observable(gen())

    # ------------------------------------------------------------- operators

    def _with(self, op: Op) -> "Observable":
        return Observable(self._source, self._ops + (op,))

    def map(self, fn: Callable[[Chunk], Chunk]) -> "Observable":
        return self._with(Op("map", fn))

    def filter(self, pred: Callable[[Chunk], torch.Tensor]) -> "Observable":
        """Dense filter: downstream sees (chunk, mask)."""
        return self._with(Op("filter", pred))

    def reduce(self, fn: Callable[[Any, Chunk, torch.Tensor], Any],
               init: Any, finish: Optional[Callable] = None
               ) -> "Observable":
        """Fold chunks into ``init``; ``finish(acc)``, when given, maps
        the terminal state to the emitted value."""
        return self._with(Op("reduce", fn, init=init,
                             meta={"finish": finish}))

    def window(self, n_chunks: int) -> "Observable":
        return self._with(Op("window", meta={"n": n_chunks}))

    def key_by(self, key_fn: Callable[[Chunk], torch.Tensor],
               num_keys: int) -> "Observable":
        return self._with(Op("key_by", key_fn, meta={"num_keys": num_keys}))

    # ------------------------------------------------------------- execution

    def subscribe(self, on_next: Optional[Callable] = None,
                  on_error: Optional[Callable] = None,
                  on_complete: Optional[Callable] = None) -> Any:
        """Drive the stream to completion (observer pattern, paper §4)."""
        state = {"reduce": None, "reduce_init": False, "window": []}
        final = None
        try:
            for chunk in self._source:
                result = self._apply_ops(chunk, state)
                if result is not None and on_next is not None:
                    on_next(result)
                final = result if result is not None else final
        except Exception as e:  # noqa: BLE001 — surfaced to the observer
            if on_error is not None:
                on_error(e)
                return None
            raise
        if state["reduce_init"]:
            final = state["reduce"]
            finish = next(o for o in self._ops
                          if o.kind == "reduce").meta.get("finish")
            if finish is not None:
                final = finish(final)
            if on_next is not None:
                on_next(final)
        if on_complete is not None:
            on_complete()
        return final

    def _apply_ops(self, chunk: Chunk, state: Dict) -> Optional[Chunk]:
        mask = None
        for op in self._ops:
            if op.kind == "map":
                chunk = op.fn(chunk)  # maps are maskwise-transparent
            elif op.kind == "filter":
                m = op.fn(chunk)
                mask = m if mask is None else (mask & m)
            elif op.kind == "reduce":
                if not state["reduce_init"]:
                    state["reduce"] = op.init
                    state["reduce_init"] = True
                state["reduce"] = op.fn(state["reduce"], chunk, mask)
                return None  # reduce swallows chunks; emits at complete
            elif op.kind == "window":
                state["window"].append((chunk, mask))
                if len(state["window"]) < op.meta["n"]:
                    return None
                chunks = state["window"]
                state["window"] = []
                chunk = _concat([c for c, _ in chunks])
                masks = [m for _, m in chunks]
                mask = None if masks[0] is None else torch.cat(masks)
            elif op.kind == "key_by":
                keys = op.fn(chunk)
                chunk = {"data": chunk, "keys": keys}
        if mask is not None:
            return {"data": chunk, "mask": mask}
        return chunk

    # ------------------------------------------------------------ inspection

    @property
    def ops(self) -> Tuple[Op, ...]:
        return self._ops

    def describe(self) -> str:
        """One-line op-chain summary (see :func:`describe_ops`)."""
        return describe_ops(self._ops)
