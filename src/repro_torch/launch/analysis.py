"""Op-level cost of one eager step, counted on ``meta`` tensors.

The port's counterpart of the reference's ``launch/hloanalysis.py``.
There is no compiled HLO to parse: PyTorch runs a step op by op, so the
step itself is run once on ``meta`` tensors (shapes and types, no data,
no launch) under a ``TorchDispatchMode`` that sees every aten op and
every call of kernel 7's operator (``torch.ops.repro_torch.
flash_attention_fwd``), and counts:

* ``flops``: ``torch.utils.flop_counter``'s formulas, 2 * M * N * K for
  each matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, ...) and kernel 7's own formula (4 * D a causal pair,
  :func:`repro_torch.kernels.flash_attention.ops.flops`).  Elementwise
  ops count none, as the reference counts ``dot`` and ``convolution``
  only.  ``flops_by_op`` splits them by op (the reference's
  ``dot_flops_by_comp``, by HLO computation, renamed: here there are
  ops, not computations).
* ``bytes``: for every op that runs a kernel, the bytes of its tensor
  inputs plus those of its outputs.  In eager PyTorch each op reads its
  inputs from and writes its outputs to device memory, so op boundaries
  approximate the card's memory traffic, as fusion boundaries do on the
  TPU for the reference.  This is a *model*, stated as such: it ignores
  the L2 cache and a kernel's re-reads.  Views and allocations
  (``empty*``) move nothing; an in-place op reads and writes its target.
* ``collective_bytes`` (by kind) and ``collective_count``: what
  :func:`repro_torch.dist.collectives.exchange`, the port's one
  collective, hands between workers.  A step on one card issues none.
* memory: ``argument_bytes`` (the step's inputs), ``peak_live_bytes``
  (the most bytes of storage alive at once, arguments included: each
  op's new output storage counts from its creation until it is freed,
  watched with ``weakref.finalize`` on the meta storage), and
  ``output_bytes`` / ``alias_bytes`` (the results' storages that are
  new / that are arguments, as a decode step's cache written in place).
  The caching allocator's rounding (512-byte blocks, 2 MB segments) and
  cuBLAS's workspace are not modelled.

Loops: the reference's point (``hloanalysis.py:3-8``) is that XLA counts
a ``while`` body once.  Eager dispatch counts every trip, so here the
trouble is time, not correctness: xlstm's sLSTM runs a Python step per
token (:func:`repro_torch.models.xlstm._slstm_scan`), millions of ops at
``prefill_32k``.  With ``scale_loops=True`` that loop runs its first trip
as is and its second once, with the second trip's counts (forward and,
through autograd markers, backward) multiplied by the trips left; the
hidden states of the skipped trips are the second trip's, and the
storage they would keep alive is held as one meta block of the same size.
Each scaled loop is named in :attr:`Analysis.loop_scaled`.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

import repro_torch.kernels.flash_attention.ops  # noqa: F401  (registers kernel 7's formula)
from repro_torch.dist import collectives


@dataclass
class Analysis:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    ops: float = 0.0                   # aten ops dispatched (scaled)
    argument_bytes: int = 0
    peak_live_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    loop_scaled: List[Dict[str, Any]] = field(default_factory=list)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided")


class _Counter(TorchDispatchMode):
    """Counts every op dispatched under it into ``self.out``."""

    def __init__(self):
        super().__init__()
        self.out = Analysis()
        self.scale = 1.0
        self.live: Dict[int, int] = {}    # storage key -> bytes
        self.live_bytes = 0

    # ---------------------------------------------------------- storage
    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.out.peak_live_bytes = max(self.out.peak_live_bytes,
                                       self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        if self.live.pop(key, None) is not None:
            self.live_bytes -= n

    # ------------------------------------------------------------ ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(result)
        s = self.scale
        self.out.ops += s
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=result) * s
            self.out.flops += f
            name = str(packet)
            self.out.flops_by_op[name] = self.out.flops_by_op.get(name, 0.0) + f
        schema = func._schema
        base = schema.name.split("::")[-1]
        views = bool(schema.returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in schema.returns)
        if not views and base not in _NO_TRAFFIC:
            if base == "copy_":        # writes self, reads only src
                ins = ins[1:]
            self.out.bytes += s * (sum(map(_nbytes, ins))
                                   + sum(map(_nbytes, outs)))
        for t in outs:
            self.track(t)
        return result

    def collective(self, kind: str, nbytes: int) -> None:
        self.out.collective_bytes += nbytes * self.scale
        self.out.collective_by_kind[kind] = \
            self.out.collective_by_kind.get(kind, 0.0) + nbytes * self.scale
        self.out.collective_count += 1


_ACTIVE: List[_Counter] = []


class _LoopEntry(torch.autograd.Function):
    """Identity on the scaled trip's inputs, the first ``n_inv`` of them
    the loop's invariants (weights every trip reads).  Its backward is the
    last of the trip's backward nodes to run (it was created before all
    of them, and the engine runs ready nodes latest-created first): it
    ends the backward's scaling, frees the skipped trips' block, and
    counts the sums of the skipped trips' gradients into each invariant
    (one add of its size a trip, which the engine makes at the invariant
    after this node)."""

    @staticmethod
    def forward(ctx, counter, rest, n_inv, *xs):
        ctx.counter, ctx.rest, ctx.n_inv, ctx.block = counter, rest, n_inv, \
            None
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        c = ctx.counter
        c.scale, ctx.block = 1.0, None
        for g in grads[:ctx.n_inv]:
            if g is not None:
                c.out.bytes += (ctx.rest - 1) * 3 * _nbytes(g)
                c.out.ops += ctx.rest - 1
        return (None, None, None) + grads


class _LoopExit(torch.autograd.Function):
    """Identity on the scaled trip's outputs; its backward, the first of
    the trip's, starts the backward's scaling."""

    @staticmethod
    def forward(ctx, counter, scale, *xs):
        ctx.counter, ctx.scale = counter, scale
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.counter.scale = ctx.scale
        return (None, None) + grads


def _scaled_slstm_scan(counter: _Counter, records: List[Dict[str, Any]]):
    """``xlstm._slstm_scan`` with its trips past the second counted from
    the second: the body is the same at every trip (one sLSTM step on
    (B, d) state), and the second, unlike the first, reads a state that
    autograd tracks."""
    from repro_torch.models import xlstm
    real = xlstm._slstm_scan

    def scan(p, cfg, state, pre, r32):
        S = pre["z"].shape[1]
        if S <= 2:
            return real(p, cfg, state, pre, r32)
        steps = {g: v.unbind(1) for g, v in pre.items()}
        state = xlstm._slstm_step(p, cfg, state,
                                  {g: v[0] for g, v in steps.items()}, r32)
        keys, gates = sorted(state), sorted(pre)
        bias = [f"b_{g}" for g in gates]
        rest = S - 1
        before = counter.live_bytes
        inv = [r32[g] for g in gates] + [p[b] for b in bias]
        ys = _LoopEntry.apply(counter, rest, len(inv), *inv,
                              *[state[k] for k in keys],
                              *[steps[g][1] for g in gates])
        entry = ys[0].grad_fn
        n_g, n_k = len(gates), len(keys)
        p1 = dict(p, **dict(zip(bias, ys[n_g:2 * n_g])))
        counter.scale = float(rest)
        try:
            st = xlstm._slstm_step(
                p1, cfg, dict(zip(keys, ys[2 * n_g:2 * n_g + n_k])),
                dict(zip(gates, ys[2 * n_g + n_k:])),
                dict(zip(gates, ys[:n_g])))
        finally:
            counter.scale = 1.0
        out = dict(zip(keys, _LoopExit.apply(counter, float(rest),
                                             *[st[k] for k in keys])))
        # what each skipped trip keeps alive: its saved tensors while the
        # backward needs them (held by the entry marker), else its h (held
        # by the h that stands for it in the list)
        per_trip = counter.live_bytes - before if entry is not None \
            else _nbytes(out["h"])
        if rest > 1 and per_trip > 0:
            block = torch.empty((per_trip * (rest - 1),), dtype=torch.uint8,
                                device="meta")
            if entry is not None:
                entry.block = block
            else:
                out["h"]._skipped_trips_block = block
        records.append(dict(loop="repro_torch.models.xlstm._slstm_scan",
                            trips=S, counted_trips=2, scaled_by=rest,
                            live_bytes_per_trip=per_trip))
        return out, [state["h"]] + [out["h"]] * rest

    return scan, real


@contextlib.contextmanager
def _scaled_loops(counter: _Counter, records: List[Dict[str, Any]]):
    from repro_torch.models import xlstm
    scan, real = _scaled_slstm_scan(counter, records)
    xlstm._slstm_scan = scan
    try:
        yield
    finally:
        xlstm._slstm_scan = real


def analyze(fn: Callable, *args, scale_loops: bool = False,
            **kwargs) -> Tuple[Analysis, Any]:
    """Run ``fn(*args, **kwargs)`` once on meta tensors and count it.  ->
    (its :class:`Analysis`, its result).  Every tensor of the arguments
    must be on ``meta``: nothing is allocated and no kernel launched."""
    arg_tensors = _tensors((args, kwargs))
    bad = {str(t.device) for t in arg_tensors if t.device.type != "meta"}
    if bad:
        raise ValueError(f"analyze: arguments on {sorted(bad)}; a step is "
                         f"counted on meta tensors only")
    counter = _Counter()
    for t in arg_tensors:
        counter.track(t)
    counter.out.argument_bytes = counter.live_bytes
    arg_keys = set(counter.live)
    loops: List[Dict[str, Any]] = []
    scaled = _scaled_loops(counter, loops) if scale_loops \
        else contextlib.nullcontext()
    with scaled, collectives.observe(counter.collective), counter:
        result = fn(*args, **kwargs)
    seen = set()
    for t in _tensors(result):
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        n = t.untyped_storage().nbytes()
        if key in arg_keys:
            counter.out.alias_bytes += n
        else:
            counter.out.output_bytes += n
    counter.out.loop_scaled = loops
    return counter.out, result
