"""Fluent pipeline builder: the paper's "few lines of code" claim.

Port of ``repro/dsl/builder.py``.  A secure pipeline is *declared*, not
assembled: named stages with worker counts and ``constraint:type==sgx``,
composed with RxLua-style ``map/filter/reduce``::

    from repro_torch.dsl import stream

    out = (stream(source)
           .map("identity", name="sgx_mapper", workers=4, sgx=True)
           .filter("delay_filter_u32", const=15, name="sgx_filter",
                   workers=4, sgx=True)
           .reduce("carrier_delay_stats", name="reducer")
           .run(mode="enclave", rekey_every_n=1024))

Builders are immutable: every combinator returns a new
:class:`StreamBuilder` whose chain is a tuple of
:class:`~repro_torch.core.observable.Op` nodes (the DSL and the
Observable layer share one vocabulary).  ``.run``/``.build`` hand the
chain to :mod:`repro_torch.dsl.compile`, which validates eagerly, fuses
where bit-exact and emits a plain :class:`repro_torch.core.pipeline.
Pipeline` on the card (``.device("cpu")`` runs the plain torch versions
of the kernels instead).  ``.as_observable()`` lowers the same chain
onto a cleartext :class:`~repro_torch.core.observable.Observable`, the
DSL's oracle.

``.trace()``, ``.monitor()``, ``.retry()`` and ``.chaos()`` attach a
span tracer, a live monitor, a retry policy and a fault plan to the
compiled pipeline (:mod:`repro_torch.obs`, :mod:`repro_torch.ft`).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Tuple, Union

from repro_torch.core.observable import Observable, Op, describe_ops


class StreamBuilder:
    """An immutable, lazily-compiled chain of named secure stages."""

    def __init__(self, source: Optional[Iterable] = None,
                 ops: Tuple[Op, ...] = (),
                 settings: Optional[dict] = None):
        self._source = source
        self._ops = tuple(ops)
        self._settings = dict(settings or {})
        #: the last Pipeline compiled by .build()/.run() (report access)
        self.pipeline = None

    # ------------------------------------------------------------- plumbing

    def _with(self, op: Op) -> "StreamBuilder":
        return StreamBuilder(self._source, self._ops + (op,), self._settings)

    def _with_settings(self, **kw) -> "StreamBuilder":
        return StreamBuilder(self._source, self._ops,
                             {**self._settings, **kw})

    @staticmethod
    def _stage_meta(kind: str, op, name: Optional[str], const: float,
                    workers: int, sgx: bool, n: int) -> dict:
        opname = op if isinstance(op, str) else getattr(op, "__name__", kind)
        return {"name": name or f"{kind}{n}_{opname}",
                "op": op if isinstance(op, str) else None,
                "const": const, "workers": workers, "sgx": sgx,
                "pinned": False}

    # ---------------------------------------------------------- combinators

    def map(self, op: Union[str, Callable], *, name: Optional[str] = None,
            const: float = 0.0, workers: int = 1,
            sgx: bool = True) -> "StreamBuilder":
        """Add a map stage.  ``op`` is a registered static operator name
        (runs fused in-enclave under ``mode="enclave"``) or a Python
        callable (attestable only outside the enclave — rejected eagerly
        by the compiler when ``sgx=True`` under enclave mode).  ``sgx``
        is the paper's ``constraint:type==sgx`` placement flag."""
        fn = None if isinstance(op, str) else op
        meta = self._stage_meta("map", op, name, const, workers, sgx,
                                len(self._ops))
        return self._with(Op("map", fn, meta=meta))

    def filter(self, op: Union[str, Callable], *,
               name: Optional[str] = None, const: float = 0.0,
               workers: int = 1, sgx: bool = True) -> "StreamBuilder":
        """Add a filter stage.  Filters are *dense* on this engine (the
        operator rewrites records in place — e.g. ``delay_filter_u32``
        zeroes non-delayed records), matching :meth:`Observable.filter`."""
        fn = None if isinstance(op, str) else op
        meta = self._stage_meta("filter", op, name, const, workers, sgx,
                                len(self._ops))
        return self._with(Op("filter", fn, meta=meta))

    def reduce(self, fn: Union[str, Callable], init: Any = None, *,
               name: str = "reduce") -> "StreamBuilder":
        """Terminal reduce: folds decrypted chunks at the trusted
        subscriber (sink edge).  ``fn`` is a callable ``(acc, chunk) ->
        acc`` with ``init``, or the name of a registered reducer
        (:func:`repro_torch.dsl.reducers.register_reducer`)."""
        meta = {"name": name, "reducer": fn if isinstance(fn, str) else None,
                "workers": 1, "sgx": True, "op": None, "const": 0.0,
                "pinned": False}
        f = None if isinstance(fn, str) else fn
        return self._with(Op("reduce", f, init=init, meta=meta))

    # ------------------------------------------------------------- settings

    def secure(self, mode: str) -> "StreamBuilder":
        """Set the wire/compute security mode (paper Fig. 6):
        ``plain`` | ``encrypted`` | ``enclave``."""
        return self._with_settings(mode=mode)

    def scale(self, stage: str, workers: int) -> "StreamBuilder":
        """Set a named stage's worker count (paper §5.5 elasticity,
        declared pre-build; a live rescale is ``Pipeline.scale_stage``).
        Scaling pins the stage: the fusion planner will not absorb it."""
        found = False
        ops = []
        for o in self._ops:
            if o.meta.get("name") == stage:
                found = True
                meta = {**o.meta, "workers": int(workers), "pinned": True}
                ops.append(Op(o.kind, o.fn, o.init, meta))
            else:
                ops.append(o)
        if not found:
            known = [o.meta.get("name") for o in self._ops]
            raise KeyError(f"scale: no stage named {stage!r} "
                           f"(stages: {known})")
        return StreamBuilder(self._source, tuple(ops), self._settings)

    def window(self, window_chunks: int) -> "StreamBuilder":
        """Set the engine's window factor (chunks per worker per batched
        dispatch; 1 = the per-chunk oracle engine)."""
        return self._with_settings(window_chunks=int(window_chunks))

    def seed(self, seed: int) -> "StreamBuilder":
        """Set the KeyDirectory seed used when no directory is passed."""
        return self._with_settings(seed=int(seed))

    def directory(self, directory) -> "StreamBuilder":
        """Use an existing :class:`repro_torch.attest.KeyDirectory`
        (shared trust domain: sessions, epoch, and revocations carry
        over)."""
        return self._with_settings(directory=directory)

    def device(self, device) -> "StreamBuilder":
        """Run on ``device`` (the card, ``"cuda"``, unless named here)."""
        return self._with_settings(device=device)

    def fuse(self, enabled: bool = True) -> "StreamBuilder":
        """Enable/disable stage fusion (default on; fusion is only
        applied where it is bit-exact, see :mod:`repro_torch.dsl.compile`)."""
        return self._with_settings(fuse=bool(enabled))

    def trace(self, tracer=None) -> "StreamBuilder":
        """Attach a :class:`repro_torch.obs.Tracer` to the compiled
        pipeline (a fresh one when ``tracer`` is None).  Per-window spans
        — ingress seals, per-worker open->op->seal, verdict syncs,
        merges, reduce folds — land on it; export with
        ``builder.tracer.export_chrome("trace.json")`` after a run.
        Tracing stays off (zero-cost no-ops) unless this is called or a
        tracer is passed to ``Pipeline.run``."""
        from repro_torch.obs.trace import Tracer
        return self._with_settings(
            tracer=tracer if tracer is not None else Tracer())

    @property
    def tracer(self):
        """The tracer attached via :meth:`trace` (None when untraced)."""
        return self._settings.get("tracer")

    def monitor(self, monitor=None) -> "StreamBuilder":
        """Attach a :class:`repro_torch.obs.PipelineMonitor` (a fresh one
        when ``monitor`` is None) to the compiled pipeline: sliding
        per-stage health (windows/s, MB/s, p50/p95 latency, queue depth,
        worker skew, mac-failure rate, epoch lag), updated once per
        window while :meth:`run` streams; read it with
        ``builder.health_monitor.snapshot()`` or serve it with
        :func:`repro_torch.obs.serve_metrics`."""
        from repro_torch.obs.monitor import PipelineMonitor
        return self._with_settings(
            monitor=monitor if monitor is not None else PipelineMonitor())

    @property
    def health_monitor(self):
        """The monitor attached via :meth:`monitor` (None when
        unmonitored)."""
        return self._settings.get("monitor")

    def retry(self, policy=None) -> "StreamBuilder":
        """Attach a :class:`repro_torch.ft.RetryPolicy` (the default
        policy when ``policy`` is None): per-share retry with bounded
        backoff, failover to survivors (or a live-enrolled spare),
        speculative backup against stragglers, and replay of MAC-failed
        rows from the retained window, every re-execution re-sealed
        under fresh directory-reserved counters.  Requires the window
        engine (``window_chunks >= 2``)."""
        from repro_torch.ft.retry import RetryPolicy
        return self._with_settings(
            retry=policy if policy is not None else RetryPolicy())

    @property
    def retry_policy(self):
        """The policy attached via :meth:`retry` (None when FT is off)."""
        return self._settings.get("retry")

    def chaos(self, plan) -> "StreamBuilder":
        """Attach a :class:`repro_torch.ft.ChaosPlan`: seeded fault
        injection (worker crashes, stalls, tampered shares, dropped
        verdict syncs, enrollment failures) consulted at every engine
        hook.  Implies :meth:`retry` with the default policy if no policy
        was attached."""
        return self._with_settings(chaos=plan)

    @property
    def chaos_plan(self):
        """The plan attached via :meth:`chaos` (None when chaos is off)."""
        return self._settings.get("chaos")

    # ------------------------------------------------------------ lowering

    def build(self, mode: Optional[str] = None, *,
              rekey_every_n: Optional[int] = None):
        """Validate + fuse + compile the chain to a
        :class:`repro_torch.core.pipeline.Pipeline` (stored as
        ``self.pipeline``).  ``rekey_every_n`` here is only used for the
        eager rekey-vs-epoch-history check; pass it to :meth:`run` to
        actually rotate."""
        from repro_torch.dsl.compile import compile_pipeline
        s = self._settings
        if rekey_every_n is None:
            rekey_every_n = s.get("rekey_every_n")   # spec-declared cadence
        self.pipeline = compile_pipeline(
            self._ops,
            mode=mode or s.get("mode", "enclave"),
            seed=s.get("seed", 0),
            directory=s.get("directory"),
            window_chunks=s.get("window_chunks", 8),
            fuse=s.get("fuse", True),
            rekey_every_n=rekey_every_n,
            device=s.get("device"),
            tracer=s.get("tracer"),
            monitor=s.get("monitor"),
            retry=s.get("retry"),
            chaos=s.get("chaos"))
        return self.pipeline

    def run(self, source: Optional[Iterable] = None, *,
            mode: Optional[str] = None, on_result: Optional[Callable] = None,
            rekey_every_n: Optional[int] = None,
            window_chunks: Optional[int] = None) -> Any:
        """Compile and stream: returns the terminal reduce value (or the
        last chunk for reduce-less chains).  The source may come from
        ``stream(source)`` or be passed here; host chunks (numpy arrays,
        u32 records as int32-carried words) are copied straight to the
        pipeline's device by the engine's ingress, tensors must already
        be there."""
        src = source if source is not None else self._source
        if src is None:
            raise ValueError("no source: pass one to stream(...) or run(...)")
        if rekey_every_n is None:
            rekey_every_n = self._settings.get("rekey_every_n")
        p = self.build(mode, rekey_every_n=rekey_every_n)
        return p.run(src, on_result=on_result, rekey_every_n=rekey_every_n,
                     window_chunks=window_chunks)

    def report(self) -> dict:
        """Per-stage metrics of the last compiled pipeline — including
        the ``fused_from`` / ``fusion`` entries recording what the
        compiler merged (see ``Pipeline.report``)."""
        if self.pipeline is None:
            raise RuntimeError("nothing compiled yet — call run()/build()")
        return self.pipeline.report()

    # --------------------------------------------------------- introspection

    def describe(self) -> str:
        """One-line chain summary, same format as
        :meth:`Observable.describe` (shared op vocabulary)."""
        return describe_ops(self._ops)

    @property
    def ops(self) -> Tuple[Op, ...]:
        return self._ops

    def as_observable(self, source: Optional[Iterable] = None) -> Observable:
        """Lower the chain onto a cleartext :class:`Observable`: each
        static stage becomes a plain torch map with the same record
        semantics as the secure engine (dense filters included), custom
        fns pass through, the terminal reduce folds in stream order.
        Chunks and accumulators live on the builder's device, host
        chunks entering as the engine's ingress takes them.
        Bit-identical to ``mode="plain"`` — the DSL's cleartext oracle."""
        from repro_torch.core.enclave import _apply_static_f32
        from repro_torch.core.pipeline import as_device_tensor, \
            resolve_device
        from repro_torch.dsl.reducers import resolve_reducer_on
        src = source if source is not None else self._source
        if src is None:
            raise ValueError("as_observable needs a source")
        dev = resolve_device(self._settings.get("device"))
        obs = Observable.from_chunks(as_device_tensor(c, dev) for c in src)
        for o in self._ops:
            if o.kind in ("map", "filter"):
                if o.fn is not None:
                    obs = obs.map(o.fn)
                else:
                    op, const = o.meta["op"], o.meta["const"]
                    obs = obs.map(
                        lambda c, _op=op, _k=const: _apply_static_f32(
                            _op, _k, c))
            elif o.kind == "reduce":
                fn, init = (o.fn, o.init) if o.fn is not None \
                    else resolve_reducer_on(o.meta["reducer"], dev)
                obs = obs.reduce(lambda acc, c, m, _f=fn: _f(acc, c),
                                 init=init,
                                 finish=getattr(fn, "finish", None))
        return obs


def stream(source: Optional[Iterable] = None) -> StreamBuilder:
    """Entry point of the fluent DSL: ``stream(chunks).map(...).run()``.
    ``source`` is any iterable of same-shape tensors/arrays (may also be
    supplied later to :meth:`StreamBuilder.run`)."""
    return StreamBuilder(source)
