"""Per-window span tracing for the streaming engine.

The port's own copy of the reference tracer.  A :class:`Tracer` records
**spans** — named intervals with monotonic timestamps, a parent/child
structure, a track (Chrome "thread" lane), and window/epoch/worker
attribution args — around the engine's units of work: ingress seal,
each stage's per-worker open->op->seal share, the one deferred-verdict
host sync per window, merge, reduce folds and rekey flips.  Export
targets:

* :meth:`Tracer.export_chrome` — the Chrome trace-event JSON format
  (load in ``chrome://tracing`` or https://ui.perfetto.dev);
* :meth:`Tracer.timeline` — a human-readable indented text timeline.

Tracing is **off by default and zero-cost when disabled**: code holds
:data:`NULL_TRACER` (a :class:`NullTracer`) unless a real tracer is
passed in, and its ``span()``/``instant()`` are no-ops returning one
shared reusable context manager — no span objects, no clock reads, no
list growth.  A span reads the host clock only: it adds no device
work and no host sync.

**The profiler bridge.**  While a ``torch.profiler`` records (the
module global ``torch.autograd.profiler._is_profiler_enabled``), every
span of a :class:`Tracer` and of :data:`NULL_TRACER` alike also opens a
``record_function`` range of its name for its extent, so the spans land
in the profiler's trace beside the device's kernels.  With no profiler
recording, :data:`NULL_TRACER` costs one attribute read more.
:meth:`Tracer.to_chrome` stamps its events on the profiler's clock:
microseconds since the Unix epoch (the tracer's t0 read by
``time.time_ns()``, offsets by ``time.perf_counter``).

**The active tracer.**  Code below a factory's call (a model layer, an
autograd backward) opens its spans with :func:`span`, into the tracer
that the call made active (:func:`active`), :data:`NULL_TRACER` else.

A deliberate caveat: spans around *asynchronously launched* device work
(category ``"dispatch"``) measure enqueue time on the host, not
execution on the card — execution lands in the per-window
``sync.verdicts`` span, which brackets the engine's single device->host
copy of the window's verdicts (and so waits for the window's kernels).
The span args carry that distinction so the timeline stays honest.
"""
from __future__ import annotations

import contextlib
import io
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from torch.autograd import profiler as _profiler


@dataclass
class Span:
    """One recorded interval (times are seconds since the tracer's t0)."""
    id: int
    name: str
    cat: str
    track: str                    # Chrome "thread" lane, e.g. "s3/w1"
    start: float
    end: Optional[float] = None   # None while open / for instants
    parent: Optional[int] = None
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return 0.0 if self.end is None else self.end - self.start


class _NoopSpan:
    """The one shared context manager NullTracer hands out."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op.

    ``enabled`` is False so hot paths that want to skip even arg
    construction can guard on it; paths that don't bother still pay only
    a method call returning a shared singleton.  While a profiler
    records, ``span`` returns a ``record_function`` of the span's name.
    """

    enabled = False

    def span(self, name: str, cat: str = "pipeline", track: str = "main",
             **args):
        if _profiler._is_profiler_enabled:
            return _profiler.record_function(name)
        return _NOOP_SPAN

    def instant(self, name: str, cat: str = "pipeline",
                track: str = "main", **args) -> None:
        return None

    def counter(self, name: str, value: float, track: str = "main") -> None:
        return None


#: The module-wide disabled tracer every component defaults to.
NULL_TRACER = NullTracer()


@dataclass
class CounterSample:
    """One sampled counter value (queue depth, windows/s) on a track."""
    name: str
    track: str
    t: float                      # seconds since the tracer's t0
    value: float


class _SpanCtx:
    """Context manager closing one span and maintaining the parent stack;
    while a profiler records, it also holds the span's
    ``record_function`` range open."""
    __slots__ = ("tracer", "span", "_range")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span
        self._range = None

    def __enter__(self) -> Span:
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.span.name)
            self._range.__enter__()
        return self.span

    def __exit__(self, *exc) -> bool:
        t = self.tracer
        self.span.end = t._clock() - t._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        if t._stack and t._stack[-1] is self.span.id:
            t._stack.pop()
        return False


class Tracer:
    """Records spans with monotonic timestamps and parent/child links.

    Single-threaded by design (the streaming engine is a generator
    chain in one thread); the parent of a new span is whatever span is
    innermost open when it starts.  (A training step's backward opens
    its spans on autograd's thread while the step's thread waits in
    ``torch.autograd.grad``, so their parent is the step's open span.)

    ``t0_ns`` is the tracer's t0 on the Unix epoch's clock
    (``time.time_ns()``), the clock of ``torch.profiler``'s events.
    """

    enabled = True

    def __init__(self):
        self._clock = time.perf_counter
        self.t0_ns = time.time_ns()
        self._t0 = self._clock()
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        self._stack: List[int] = []          # open span ids (parent chain)

    # ------------------------------------------------------------ recording

    def span(self, name: str, cat: str = "pipeline", track: str = "main",
             **args) -> _SpanCtx:
        """Open a span; close it by exiting the returned context manager."""
        s = Span(id=len(self.spans), name=name, cat=cat, track=track,
                 start=self._clock() - self._t0,
                 parent=self._stack[-1] if self._stack else None,
                 args=args)
        self.spans.append(s)
        self._stack.append(s.id)
        return _SpanCtx(self, s)

    def instant(self, name: str, cat: str = "pipeline",
                track: str = "main", **args) -> Span:
        """A zero-duration marker (e.g. a rekey flip)."""
        t = self._clock() - self._t0
        s = Span(id=len(self.spans), name=name, cat=cat, track=track,
                 start=t, end=t,
                 parent=self._stack[-1] if self._stack else None,
                 args=args)
        self.spans.append(s)
        return s

    def counter(self, name: str, value: float, track: str = "main") -> None:
        """Sample a load curve (queue depth, windows/s) — rendered by
        Perfetto as a stacked area chart via Chrome "C" events."""
        self.counters.append(CounterSample(
            name=name, track=track, t=self._clock() - self._t0,
            value=float(value)))

    # -------------------------------------------------------------- queries

    def find(self, name: Optional[str] = None,
             cat: Optional[str] = None) -> List[Span]:
        """Spans filtered by exact name and/or category (tests)."""
        return [s for s in self.spans
                if (name is None or s.name == name)
                and (cat is None or s.cat == cat)]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def __len__(self) -> int:
        return len(self.spans)

    # -------------------------------------------------------------- export

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event dict (``{"traceEvents": [...]}``).

        Complete ("X") events carry ``ts``/``dur`` in microseconds, ``ts``
        on the profiler's clock (since the Unix epoch), so they lie over
        a ``torch.profiler`` export's own in one view.  Each distinct
        track becomes a named tid via ``thread_name`` metadata events, so
        stages and workers render as separate lanes.
        """
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        t0_us = self.t0_ns / 1e3

        def ts(t: float) -> float:
            return round(t0_us + t * 1e6, 3)

        for s in self.spans:
            tid = tids.setdefault(s.track, len(tids))
            ev: Dict[str, Any] = {
                "name": s.name, "cat": s.cat or "pipeline", "pid": 1,
                "tid": tid, "ts": ts(s.start),
            }
            if s.end is not None and s.end > s.start:
                ev["ph"] = "X"
                ev["dur"] = round(s.dur * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"                 # instant scoped to its thread
            if s.args:
                ev["args"] = {k: (v if isinstance(v, (int, float, str,
                                                      bool, type(None)))
                                  else str(v)) for k, v in s.args.items()}
            events.append(ev)
        for c in self.counters:
            tid = tids.setdefault(c.track, len(tids))
            events.append({
                "name": c.name, "cat": "load", "ph": "C", "pid": 1,
                "tid": tid, "ts": ts(c.t),
                "args": {"value": c.value},
            })
        meta = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                 "args": {"name": "repro.pipeline"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                  "args": {"name": track}}
                 for track, tid in sorted(tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Write (when ``path`` is given) and return the Chrome trace
        dict — load the file in ``chrome://tracing`` / Perfetto."""
        doc = self.to_chrome()
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

    def timeline(self) -> str:
        """Human-readable indented timeline (ms offsets, span tree)."""
        depth: Dict[int, int] = {}
        buf = io.StringIO()
        for s in self.spans:
            d = 0 if s.parent is None else depth.get(s.parent, 0) + 1
            depth[s.id] = d
            attrs = " ".join(f"{k}={v}" for k, v in s.args.items())
            mark = f"[{s.start * 1e3:9.3f}ms +{s.dur * 1e3:8.3f}ms]"
            buf.write(f"{mark} {'  ' * d}{s.name} ({s.track})"
                      + (f" {attrs}" if attrs else "") + "\n")
        return buf.getvalue()


_active: Any = NULL_TRACER


@contextlib.contextmanager
def active(tracer):
    """Within, :func:`span` opens its spans in ``tracer``; the tracer
    active before comes back after.  One for the process, not one a
    thread: a backward's spans open on autograd's thread while the
    step's thread waits in ``torch.autograd.grad``."""
    global _active
    before, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = before


def span(name: str, **kw):
    """A span of the active tracer (:func:`active`)."""
    return _active.span(name, **kw)
