"""The card's idle time by the program's own spans, in the pass of a trace
with the host's activity (:class:`portbench.lib.trace.Trace`).

The program opens its spans as ``record_function`` ranges whenever a
profiler records (``repro_torch.obs.trace``), so they are host events of
that pass, on the clock of its device intervals.  At each moment of the
pass's window the *innermost* open span of a set of names is the one
opened last (of two opened together, the one that closes first): so the
names partition the window, and the card's idle time under each, with
the idle time under none, adds up to the pass's idle time.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from portbench.lib.trace import gaps

#: a training step's spans (``repro_torch.train.steps``, ``models.flash``)
STEP_SPANS = ("train.fwd", "train.bwd", "attn.bwd", "train.optimizer")
#: the key of the idle time under none of the names
OUTSIDE = ""

Segment = Tuple[int, int, str]


def innermost(host: Iterable[Tuple[str, int, int]], names: Iterable[str],
              window: Tuple[int, int]) -> List[Segment]:
    """The window cut where the innermost open span of ``names`` changes:
    sorted, disjoint (start, end, name) segments covering it, the name
    :data:`OUTSIDE` where none is open."""
    wanted = set(names)
    w0, w1 = window
    spans = [(s, t, n) for n, s, t in host if n in wanted and t > s]
    cuts = sorted({w0, w1} | {x for s, t, _ in spans for x in (s, t)
                              if w0 < x < w1})
    out: List[Segment] = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s, -t, n) for s, t, n in spans if s <= a and t >= b]
        name = max(open_)[2] if open_ else OUTSIDE
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def split_by(intervals: Iterable[Tuple[int, int]],
             segments: List[Segment]) -> Dict[str, int]:
    """Nanoseconds of the sorted, disjoint ``intervals`` in each name's
    segments (sorted, disjoint, as :func:`innermost` gives them)."""
    out: Dict[str, int] = {}
    i = 0
    for gs, gt in intervals:
        while i < len(segments) and segments[i][1] <= gs:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < gt:
            s, t, name = segments[j]
            out[name] = out.get(name, 0) + min(t, gt) - max(s, gs)
            j += 1
    return out


def idle_ns(trace, names: Iterable[str] = STEP_SPANS) -> Dict[str, int]:
    """Idle nanoseconds of the card in ``trace``'s pass with the host
    (``host_busy``'s gaps in ``host_window``) under each of ``names``
    that the pass holds as its innermost open span, and under none
    (:data:`OUTSIDE`).  A name the trace holds no span of is absent."""
    names = tuple(names)
    held = {n for n, _, _ in trace.host if n in names}
    got = split_by(gaps(trace.host_busy, trace.host_window),
                   innermost(trace.host, names, trace.host_window))
    return {n: got.get(n, 0) for n in sorted(held) + [OUTSIDE]}


def idle_ms_a_step(r, name: str) -> Optional[float]:
    """A training metric: the card's idle ms a traced step while ``name``
    is the innermost open one of :data:`STEP_SPANS`; None where the run
    has no trace or its trace holds no ``name`` span."""
    if r.trace is None or not r.traced_work:
        return None
    got = idle_ns(r.trace).get(name)
    return None if got is None else got / 1e6 / len(r.traced_work)
