"""Metrics registry: named counters, gauges, and histograms.

The port's own copy of the reference registry (same names, same
semantics, a separate process-wide :data:`REGISTRY`): the window engine
counts ``pipeline.host_syncs`` and ``device.dispatches.*`` here, and the
per-stage window-latency histograms and queue-depth gauges live here.
Kernel *launches* are counted separately, on each kernel wrapper
(:func:`repro_torch.kernels.build.launch_counts`).

Design constraints, in order:

* **hot-path cheap** — instruments are plain objects with one mutable
  slot; callers resolve them ONCE (``c = REGISTRY.counter(name)``) and
  then call ``c.inc()`` per event, so the per-event cost is an attribute
  add, not a dict lookup;
* **one namespace** — a name is bound to exactly one instrument kind;
  re-requesting it returns the SAME object (shims and tests can reset a
  counter without invalidating references held by the hot path), and
  requesting it as a different kind is an error, not a shadow;
* **stdlib only** — this module imports nothing from the rest of the
  package, so every layer (crypto, core, attest) can depend on it
  without cycles.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonic event count (resettable by tests/benchmarks only)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written level (queue depth, buffered rows, pool size)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Streaming distribution with exact percentiles.

    Samples are kept in sorted order (insertion is a bisect — windows
    arrive a few per second, not millions), so ``percentile`` is an
    index, not a sort.  ``max_samples`` bounds memory on unbounded
    streams by dropping the OLDEST samples (the percentiles then cover a
    sliding suffix — exactly what a latency SLO controller wants).
    """

    __slots__ = ("name", "_sorted", "_order", "count", "total",
                 "max_samples")

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self._sorted: List[float] = []   # ascending sample values
        self._order: List[float] = []    # arrival order (for eviction)
        self.count = 0                   # lifetime observations
        self.total = 0.0                 # lifetime sum
        self.max_samples = max_samples

    def observe(self, v: Number) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        bisect.insort(self._sorted, v)
        self._order.append(v)
        if len(self._order) > self.max_samples:
            old = self._order.pop(0)
            del self._sorted[bisect.bisect_left(self._sorted, old)]

    def percentile(self, q: float) -> Optional[float]:
        """Exact q-th percentile (0..100) of the retained samples;
        None before the first observation."""
        if not self._sorted:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile wants 0..100, got {q}")
        idx = min(len(self._sorted) - 1,
                  int(round(q / 100.0 * (len(self._sorted) - 1))))
        return self._sorted[idx]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def summary(self) -> Dict[str, Optional[float]]:
        """{count, mean, p50, p95, p99, max} — None-valued before data."""
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "max": self._sorted[-1] if self._sorted else None}

    def reset(self) -> None:
        self._sorted.clear()
        self._order.clear()
        self.count = 0
        self.total = 0.0


class MetricsRegistry:
    """Name -> instrument map with get-or-create semantics."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name)
            self._instruments[name] = inst
        elif type(inst) is not cls:
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, requested "
                f"as {cls.__name__} — one name, one instrument kind")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def get(self, name: str):
        """The instrument registered under ``name`` (None if absent) —
        read-side access that never creates."""
        return self._instruments.get(name)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time dump: counters/gauges -> value, histograms ->
        their :meth:`Histogram.summary` dict."""
        out: Dict[str, object] = {}
        for name, inst in sorted(self._instruments.items()):
            out[name] = inst.summary() if isinstance(inst, Histogram) \
                else inst.value
        return out

    def reset(self, prefix: str = "") -> None:
        """Zero every instrument whose name starts with ``prefix`` —
        instruments stay registered (hot-path references stay valid)."""
        for name, inst in self._instruments.items():
            if name.startswith(prefix):
                inst.reset()


#: The process-wide default registry every layer registers into.
REGISTRY = MetricsRegistry()

#: Every wrapper-level device program (aead seal/open_many,
#: mac_keys_many, mac2_many, enclave_map_rows) increments this one
#: counter, exactly where the reference counts its compiled-program
#: launches, so per-hop dispatch counts match the reference's.
#: Per-site breakdowns live under ``device.dispatches.<site>``.
DISPATCHES = REGISTRY.counter("device.dispatches")


def dispatch_count() -> int:
    """Total wrapper-level device programs since the last reset — the
    per-hop regression signal next to ``host_sync_count()``."""
    return DISPATCHES.value


def reset_dispatch_count() -> None:
    """Zero the global dispatch counter and every per-site breakdown."""
    REGISTRY.reset("device.dispatches")
