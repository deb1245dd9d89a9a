"""The device's time in a traced window, from ``torch.profiler``.

The traced work runs twice.  First with the card's activity alone, which
costs the host nothing: its window runs from a one-element kernel
launched after a sync to another launched after the work, and the device
is busy where at least one kernel, copy or set runs (the union of their
intervals, so overlapping events count once).  Then with the host's
activity too, under the ``portbench.window`` annotation: that pass only
names each of its longest idle gaps by what the host was doing when the
gap began (the innermost host event open then, under the harness's span
around it); tracing the host slows it, so those gaps are longer than the
first pass's.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
SPAN = "portbench."
#: the kinds of device event that are work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[int, int]
Event = Tuple[str, int, int]


def record(work: Callable[[int], None]) -> Optional["Trace"]:
    """``work(0)`` traced on the card alone, then ``work(1)`` with the
    host -> the trace, or None without a card."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        return None

    def mark():
        torch.cuda.synchronize()
        torch.zeros(1, device="cuda")

    mark()
    with profile(activities=[ProfilerActivity.CUDA]) as card:
        mark()      # twice: a session may lose its first device event
        mark()
        work(0)
        mark()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as both:
        with record_function(WINDOW):
            work(1)
            torch.cuda.synchronize()
    return Trace(card.profiler.kineto_results.events(),
                 both.profiler.kineto_results.events())


def is_work(e) -> bool:
    """A device event that is work: a kernel, copy or set.  An annotation's
    range on the device spans its kernels and idle time alike.  (The
    event's kind is read where the profiler gives it, else whether it is
    an annotation, else its name.)"""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    annotation = getattr(e, "is_user_annotation", None)
    if annotation is not None and annotation():
        return False
    return not e.name().startswith(SPAN)


def split(events) -> Tuple[List[Event], List[Event]]:
    """(device work, host events) of a profiler's events."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in events:
        s = e.start_ns()
        ev = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if is_work(e):
                device.append(ev)
        else:
            host.append(ev)
    return device, host


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


class Trace:
    """``card``: the events of the pass with the card's activity alone;
    ``both``: those of the pass with the host's too."""

    def __init__(self, card, both) -> None:
        self.device, _ = split(card)
        if not self.device:
            raise RuntimeError("the trace holds no device work")
        self.window = (min(s for _, s, _ in self.device),
                       max(t for _, _, t in self.device))
        device, self.host = split(both)
        spans = [(s, t) for n, s, t in self.host if n == WINDOW]
        if not spans:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        w0, w1 = spans[0]
        self.host_window = (w0, w1)
        self.host_busy = union([(max(s, w0), min(t, w1))
                                for _, s, t in device if t > w0 and s < w1])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Interval]:
        return union([(s, t) for _, s, t in self.device])

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) / 1e9

    def device_s(self, pattern: str) -> float:
        """Device seconds of the events whose name matches ``pattern``
        (case-insensitive), overlaps counted once."""
        rx = re.compile(pattern, re.IGNORECASE)
        return sum(t - s for s, t in union(
            [(s, t) for n, s, t in self.device if rx.search(n)])) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for name, s, t in self.device:
            by[name] = by.get(name, 0) + (t - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps of the pass with the host, each
        named by the host's work."""
        found = sorted(gaps(self.host_busy, self.host_window),
                       key=lambda g: g[0] - g[1])
        return [[self._host_at(s), (t - s) / 1e9] for s, t in found[:n]]

    def _host_at(self, at: int) -> str:
        span = inner = None
        for name, s, t in self.host:
            if s <= at < t and name != WINDOW:
                if name.startswith(SPAN):
                    if span is None or t - s < span[1]:
                        span = (name, t - s)
                elif inner is None or t - s < inner[1]:
                    inner = (name, t - s)
        where = span[0] if span else "outside the harness's spans"
        return f"{where} / {inner[0] if inner else 'no host op'}"[:120]
