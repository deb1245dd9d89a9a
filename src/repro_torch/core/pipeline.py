"""Pipeline: named stages -> an executable secure dataflow.

Port of the window engine of ``repro/core/pipeline.py``.  A pipeline is a
list of named stages (the paper's Listing 1), each with an operator, a
worker count and a placement; stages between the attested ingress and
the trusted sink run under the configured security mode.

Execution is streaming and **window-vectorized**: the unit of device
work is a window of ``window_chunks`` chunks per worker.  Ingress seals
whole windows with the batched AEAD (window N+1 is sealed before window
N is handed downstream, so its kernels queue behind the downstream
work), with nonce-counter blocks reserved per window from the directory.
Each stage dispatches every worker's share of a window as ONE batched
open -> operator -> seal chain, and MAC verdicts are **deferred**: they
stay on the device and reach the host once per window (one device->host
copy, :func:`_sync_window`), where failed rows are dropped and counted.

``window_chunks=1`` runs the per-chunk oracle engine instead (the
paper's seed engine, kept as the bitwise oracle): one scalar seal, open
and enclave hop per chunk, with a blocking host sync for each MAC
verdict, round-robin dispatch over the stage's workers and a fair-queue
merge of their outputs (:mod:`repro_torch.core.router`).

Per-edge session keys come from a :class:`KeyDirectory`: every stage
worker is measured, enrolled and admitted only if its quote verifies,
and edge keys are established by the attested handshake.
``run(rekey_every_n=...)`` rotates every edge key mid-stream; a window
straddling a flip opens every row under its ingress epoch, and
``KeyDirectory.revoke`` evicts a worker live.

Telemetry is opt-in and host-side: a ``tracer=``
(:class:`repro_torch.obs.Tracer`) records spans around ingress seals,
each worker's open -> op -> seal share, the per-window verdict sync,
merges and reduce folds, and a ``monitor=``
(:class:`repro_torch.obs.PipelineMonitor`) folds each window into its
sliding per-stage health.  Neither adds a host sync or a device
program: ``pipeline.host_syncs`` and ``device.dispatches`` read the same
with and without them.

Fault tolerance is opt-in too: a ``retry=`` policy
(:class:`repro_torch.ft.RetryPolicy`) or a ``chaos=`` plan
(:class:`repro_torch.ft.ChaosPlan`) runs the window engine's stages
through :meth:`Pipeline._stage_stream_ft` — per-share retry with
backoff, failover to a survivor or a live-enrolled spare, speculative
backup against stragglers, and replay of tampered or unverified rows
from the retained sealed inputs.  Every re-execution re-seals under a
fresh counter block reserved from the ingress edge (in enclave mode the
fused kernel encrypts straight under those outbound coordinates), so
recovery never spends a (key, nonce, counter) twice and the terminal
reduce equals the fault-free run's.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from repro_torch.attest.directory import (EdgeHandle, KeyDirectory,
                                          KeyDirectoryError)
from repro_torch.attest.measure import IO_ENDPOINT, measure_stage
from repro_torch.attest.quote import QuoteError
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import router as R
from repro_torch.core.enclave import (EnclaveExecutor, SealedChunk,
                                      SealedWindow, egress, egress_window,
                                      ingress, plain_window,
                                      seal_tensors_window, uniform_runs)
from repro_torch.ft.recovery import FTContext
from repro_torch.ft.retry import RetryPolicy
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.monitor import NULL_MONITOR
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.u32 import from_numpy, host_to_device


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Without a card, ``None`` or ``"cuda"`` is an error:
    nothing moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch "
            "versions of the kernels on the CPU")
    return dev


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """A source chunk on ``device``: host data enters here (uint32
    records viewed as int32 words, others as they are, copied straight
    to the device); tensors must already be on the device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype in (np.uint32, np.int32):
            return from_numpy(x, device)
        return torch.as_tensor(x, device=device)
    if x.device != device:
        raise ValueError(f"source tensor on {x.device}, pipeline on "
                         f"{device}")
    return x


@dataclass
class Stage:
    """One named pipeline stage — the paper's Listing-1 unit.

    ``op`` names a statically registered operator
    (``repro_torch.kernels.enclave_map.enclave_map.OPS`` — the only code
    attestable under ``mode="enclave"``) or ``"custom"`` when
    ``fn``/``reduce_fn`` carries a Python callable (plain/encrypted
    modes only).  ``workers`` is the stage's fan-out pool size; ``sgx``
    is the paper's ``constraint:type==sgx`` placement flag (non-sgx
    stages run on the encrypted path when the pipeline mode is
    ``enclave``).  A stage with ``reduce_fn`` is terminal: it folds
    decrypted chunks at the trusted sink edge, seeded with
    ``reduce_init``."""
    name: str
    op: str                              # static registry op name, or "custom"
    const: float = 0.0
    fn: Optional[Callable] = None        # custom fn (plain/encrypted only)
    workers: int = 1
    sgx: bool = True                     # paper: constraint:type==sgx
    reduce_fn: Optional[Callable] = None # terminal reduce (runs at egress)
    reduce_init: Any = None


@dataclass
class StageMetrics:
    """Per-stage counters behind ``Pipeline.report()`` (paper Fig. 6-8):
    surviving chunks, payload bytes, execution seconds (measured at
    window granularity through the window's host sync), MAC failures,
    per-worker chunk counts, windows and wrapper-level dispatches."""
    chunks: int = 0
    bytes: int = 0
    seconds: float = 0.0
    mac_failures: int = 0
    per_worker: List[int] = field(default_factory=list)
    windows: int = 0
    dispatches: int = 0

    @property
    def dispatches_per_window(self) -> Optional[float]:
        if self.windows == 0:
            return None
        return self.dispatches / self.windows

    @property
    def throughput_mbps(self) -> Optional[float]:
        """Payload MB/s over the measured seconds (None: nothing measured)."""
        if self.seconds <= 0.0:
            return None
        return (self.bytes / 1e6) / self.seconds

    @property
    def mac_failure_rate(self) -> Optional[float]:
        seen = self.chunks + self.mac_failures
        if seen == 0:
            return None
        return self.mac_failures / seen


# One host rendezvous per window (the deferred verdicts' single
# device->host copy, which also waits for the window's kernels).
_HOST_SYNCS = _METRICS.counter("pipeline.host_syncs")
_DISPATCHES = _METRICS.counter("device.dispatches")


def host_sync_count() -> int:
    """Device->host rendezvous performed by the streaming engine (one
    per window)."""
    return int(_HOST_SYNCS.value)


def reset_host_sync_count() -> None:
    _HOST_SYNCS.reset()


def _finish(fn: Callable, acc: Any) -> Any:
    """The terminal reduce value: ``fn.finish(acc)`` when the reducer
    has one (see ``repro_torch.dsl.reducers``), else ``acc``."""
    finish = getattr(fn, "finish", None)
    return acc if finish is None else finish(acc)


def _shape_runs(xs: List[torch.Tensor]):
    """Consecutive same-(shape, dtype) runs of a tensor list — each run
    frames as one batched window (ragged tails get their own)."""
    return uniform_runs(xs, lambda x: (tuple(x.shape), x.dtype))


def _sync_window(outputs: List[torch.Tensor],
                 vec_specs: List[Tuple[Optional[torch.Tensor], int]],
                 device: torch.device, tracer=NULL_TRACER,
                 track: str = "main") -> np.ndarray:
    """THE one host sync of a window: every deferred MAC verdict in a
    single device->host copy, which is queued behind (and so waits for)
    every kernel of the window.  ``vec_specs`` is [(device verdict
    vector or None, n)]; None (plain mode) counts as all-pass.  The
    ``sync.verdicts`` span is where device time surfaces on a timeline:
    dispatch spans upstream only measure the host's enqueue."""
    _HOST_SYNCS.inc()
    with tracer.span("sync.verdicts", cat="sync", track=track,
                     rows=sum(n for _, n in vec_specs)):
        if all(ok is None for ok, _ in vec_specs):
            if outputs and device.type == "cuda":
                torch.cuda.synchronize(device)
            return np.ones(sum(n for _, n in vec_specs), bool)
        parts = [torch.ones((n,), dtype=torch.bool, device=device)
                 if ok is None else ok for ok, n in vec_specs]
        vec = parts[0] if len(parts) == 1 else torch.cat(parts)
        return vec.cpu().numpy()


class Pipeline:
    """An executable secure dataflow: ordered :class:`Stage` list +
    per-edge attested session keys, streamed by the window engine (or,
    at a window factor of 1, the per-chunk oracle engine) on ``device``
    (``"cuda"`` by default; ``"cpu"`` runs the plain torch versions of
    the kernels).

    ``fusion`` is builder metadata from :mod:`repro_torch.dsl.compile`: a
    ``{"fused_from": {survivor: [absorbed stage names]}, "decisions":
    [...]}`` record of bit-exact stage merges, surfaced via
    :meth:`report`; hand-built pipelines leave it empty.

    ``tracer``/``monitor`` attach span tracing and live health to every
    run (each off by default: :data:`NULL_TRACER`, :data:`NULL_MONITOR`);
    ``retry``/``chaos`` enable the fault-tolerant window engine (see the
    module docstring).  :meth:`run` takes each of the four for one run
    only."""

    def __init__(self, stages: Sequence[Stage],
                 secure: SecureStreamConfig = SecureStreamConfig(),
                 seed: int = 0,
                 directory: Optional[KeyDirectory] = None,
                 window_chunks: int = 8,
                 fusion: Optional[Dict[str, Any]] = None,
                 device=None,
                 tracer=None,
                 monitor=None,
                 retry=None,
                 chaos=None):
        self.device = resolve_device(device)
        self.stages = list(stages)
        self.secure = secure
        self.seed = seed
        # telemetry is off unless asked for: the NULL objects' calls are
        # no-ops, so the instrumented paths cost an attribute call
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.monitor = monitor if monitor is not None else NULL_MONITOR
        # fault tolerance is opt-in the same way: ``retry`` is a
        # RetryPolicy, ``chaos`` a ChaosPlan; with both None the engine
        # runs the plain stage stream
        self.retry = retry
        self.chaos = chaos
        self._last_ft = None        # FTContext of the most recent run
        # dispatch/window accounting for the ingress and egress hops
        # (stage hops live in StageMetrics)
        self._ingress_windows_n = 0
        self._ingress_dispatches = 0
        self._egress_windows_n = 0
        self._egress_dispatches = 0
        # worker ids whose eviction has already been audit-logged
        self._evicted_logged: set = set()
        # DSL-compiler provenance (stage merges); never read on the hot path
        self.fusion: Dict[str, Any] = dict(fusion or {})
        # chunks per worker per window: each worker's queue of a window is
        # ONE batched device dispatch; 1 = the per-chunk oracle engine
        self.window_chunks = max(1, int(window_chunks))
        self.directory = directory if directory is not None \
            else KeyDirectory(seed=seed)
        self._setup_attestation()
        # edge i connects stage i-1 -> i (+ source and sink); plain mode
        # never touches a key, so it skips the edge handshakes
        self.keys: List[Optional[EdgeHandle]] = [
            self.directory.handle(f"edge{i}")
            for i in range(len(self.stages) + 1)
        ] if secure.mode != "plain" else [None] * (len(self.stages) + 1)
        self.metrics: Dict[str, StageMetrics] = {
            s.name: StageMetrics() for s in self.stages}
        self.monitor.attach(self)

    # -------------------------------------------------------- attestation

    @staticmethod
    def worker_id(stage_name: str, w: int) -> str:
        """Directory identity of worker ``w`` of a stage — the id
        ``KeyDirectory.revoke`` takes to evict it live."""
        return f"{stage_name}/w{w}"

    def _setup_attestation(self) -> None:
        """Measure + enroll every endpoint and worker, verify quotes, and
        establish per-edge session keys via the attested handshake.
        Revoked worker ids stay quarantined; existing edge sessions are
        reused so a rescale does not re-key the stream."""
        d = self.directory
        S = len(self.stages)
        endpoints = ["io/source"] + [f"stage/{s.name}" for s in self.stages] \
            + ["io/sink"]
        d.enroll("io/source", IO_ENDPOINT, allow=True)
        d.enroll("io/sink", IO_ENDPOINT, allow=True)
        for st in self.stages:
            m = measure_stage(op=st.op, const=st.const, fn=st.fn, sgx=st.sgx)
            d.policy.allow(m)
            d.enroll(f"stage/{st.name}", m)
            for w in range(max(1, st.workers)):
                wid = self.worker_id(st.name, w)
                if d.policy.is_revoked(wid):
                    continue                     # stays evicted
                d.enroll(wid, m)
                d.admit(wid)                     # raises unless quote verifies
        if self.secure.mode == "plain":
            return                               # no keys -> no handshakes
        for i in range(S + 1):
            if not d.has_session(f"edge{i}"):
                d.establish(f"edge{i}", endpoints[i], endpoints[i + 1],
                            stage_id=i)

    def _live_workers(self, st: Stage) -> List[int]:
        """Worker indices still dispatchable (revocation is the only bit
        that can flip mid-stream: a set lookup per window)."""
        live = []
        for w in range(max(1, st.workers)):
            wid = self.worker_id(st.name, w)
            if self.directory.policy.is_revoked(wid):
                if wid not in self._evicted_logged:
                    self._evicted_logged.add(wid)
                    self.directory.audit.record("eviction", worker=wid,
                                                stage=st.name)
                continue
            live.append(w)
        if not live:
            raise KeyDirectoryError(
                f"every worker of stage {st.name!r} is revoked or "
                f"inadmissible — nothing can process the edge")
        return live

    # ------------------------------------------------------------------ run

    def _executor(self, i: int, st: Stage, w: int) -> EnclaveExecutor:
        """Worker ``w`` of stage i: the stage's mode (non-sgx stages run
        encrypted under enclave mode), the edge keys, and the run's
        tracer on the worker's own lane."""
        mode = self.secure.mode
        st_mode = mode if st.sgx else ("plain" if mode == "plain"
                                       else "encrypted")
        ex = EnclaveExecutor(st_mode, self.keys[i], self.keys[i + 1])
        ex.tracer = self.tracer
        ex.track = f"{st.name}/w{w}"
        return ex

    def _worker_pool(self, i: int, st: Stage) -> List[EnclaveExecutor]:
        """One executor per worker of stage i, all sharing the edge keys."""
        return [self._executor(i, st, w) for w in range(max(1, st.workers))]

    def _stage_stream(self, upstream: Iterator[SealedWindow], st: Stage,
                      pool: List[EnclaveExecutor],
                      window_chunks: int) -> Iterator[SealedWindow]:
        """Fan a window stream across the stage's workers.

        Each round accumulates ``len(live) * window_chunks`` rows,
        round-robins them over the live workers by rolling global row
        index (row g goes to worker g mod W), and runs each worker's
        share as ONE batched dispatch (a device gather splits the
        window; a single live worker gets the window untouched).  The
        round syncs to host ONCE; failed rows are dropped and counted,
        and survivors flow on in stream order.  Revocation is re-checked
        per round, so a revoked worker stops receiving rows at the next
        dispatch."""
        m = self.metrics[st.name]
        if len(m.per_worker) < len(pool):
            m.per_worker.extend([0] * (len(pool) - len(m.per_worker)))
        tr = self.tracer
        audit = self.directory.audit
        lat = _METRICS.histogram(f"pipeline.stage.{st.name}.window_seconds")
        depth = _METRICS.gauge(f"pipeline.stage.{st.name}.queue_rows")
        phase = 0                    # rolling global row index for rr
        while True:
            live = self._live_workers(st)
            parts, got = self._pull_round(upstream,
                                          len(live) * window_chunks)
            if not parts:
                return
            depth.set(got)
            tr.counter("queue_rows", got, track=st.name)
            # pulling the window may itself have revoked workers upstream
            live = self._live_workers(st)
            L = len(live)
            d0 = _DISPATCHES.value
            t0 = time.perf_counter()
            dispatches = []          # (part idx, worker, row idxs, out, ok)
            with tr.span("stage.dispatch", cat="dispatch", track=st.name,
                         rows=got, workers=L):
                for pi, win in enumerate(parts):
                    B = len(win)
                    assign = [(phase + j) % L for j in range(B)]
                    phase += B
                    for k in range(L):
                        idxs = [j for j in range(B) if assign[j] == k]
                        if not idxs:
                            continue
                        sub = win if len(idxs) == B else win.select(idxs)
                        w = live[k]
                        if st.fn is not None:
                            out, ok = pool[w].run_window(st.fn, sub)
                        else:
                            out, ok = pool[w].run_static_window(
                                st.op, st.const, sub)
                        dispatches.append((pi, w, idxs, out, ok))
            verdicts = _sync_window(
                [d[3].words for d in dispatches],
                [(d[4], len(d[3])) for d in dispatches], self.device,
                tracer=tr, track=st.name)
            dt = time.perf_counter() - t0
            m.seconds += dt
            lat.observe(dt)
            m.windows += 1
            disp = _DISPATCHES.value - d0
            m.dispatches += disp
            tr.counter("windows_per_s", (1.0 / dt) if dt > 0 else 0.0,
                       track=st.name)
            off = 0
            marks: List[np.ndarray] = []
            for pi, w, idxs, out, _ in dispatches:
                v = verdicts[off: off + len(idxs)]
                off += len(idxs)
                marks.append(v)
                for jj, alive in enumerate(v):
                    if alive:
                        m.chunks += 1
                        m.per_worker[w] += 1
                        m.bytes += int(parts[pi].n_words) * 4
                    else:
                        m.mac_failures += 1
                        pool[w].errors += 1
                        audit.record("mac_failure", stage=st.name,
                                     worker=self.worker_id(st.name, w),
                                     row=out.counters[jj],
                                     epoch=out.epochs[jj])
            self._record_stage_window(st, parts, got, dispatches, marks, dt,
                                      disp)
            with tr.span("stage.merge", cat="pipeline", track=st.name,
                         windows=len(parts)):
                merged = list(self._merge_outputs(parts, dispatches, marks))
            yield from merged

    @staticmethod
    def _pull_round(upstream: Iterator[SealedWindow], target: int
                    ) -> Tuple[List[SealedWindow], int]:
        """Pull upstream windows until ``target`` rows (or the stream's
        end) -> (windows, rows)."""
        parts: List[SealedWindow] = []
        got = 0
        while got < target:
            win = next(upstream, None)
            if win is None:
                break
            parts.append(win)
            got += len(win)
        return parts, got

    def _record_stage_window(self, st: Stage, parts, got: int, dispatches,
                             marks, dt: float, disp: int) -> None:
        """Fold one stage round into the live monitor, from host-side
        numbers only (the round's numpy verdicts, row counts, epochs)."""
        mon = self.monitor
        if not mon.enabled:
            return
        wrows: Dict[int, int] = {}
        for _, w, idxs, _, _ in dispatches:
            wrows[w] = wrows.get(w, 0) + len(idxs)
        mon.record_window(
            st.name, rows=got, ok_rows=int(sum(int(v.sum()) for v in marks)),
            bytes=sum(len(p) * int(p.n_words) * 4 for p in parts),
            seconds=dt, queue_rows=got, worker_rows=wrows,
            min_epoch=min(min(p.epochs) for p in parts), dispatches=disp)

    @staticmethod
    def _merge_outputs(parts, dispatches, marks):
        """Reassemble each input window's surviving rows in stream order.
        The all-survived single-dispatch case (steady state) passes the
        worker's output through untouched; otherwise one concatenate +
        one gather rebuilds the window."""
        for pi in range(len(parts)):
            ds = [(d, mk) for d, mk in zip(dispatches, marks) if d[0] == pi]
            if not ds:
                continue
            if len(ds) == 1 and len(ds[0][0][2]) == len(parts[pi]) \
                    and bool(ds[0][1].all()):
                yield ds[0][0][3]
                continue
            outs = [d[3] for d, _ in ds]
            cat_w = outs[0].words if len(outs) == 1 \
                else torch.cat([o.words for o in outs])
            cat_t = outs[0].tags
            if cat_t is not None and len(outs) > 1:
                cat_t = torch.cat([o.tags for o in outs])
            entries = []             # (orig row, concat pos, counter, epoch)
            pos = 0
            for (_, _, idxs, out, _), mk in ds:
                entries.extend((j, pos + jj, out.counters[jj],
                                out.epochs[jj])
                               for jj, j in enumerate(idxs) if mk[jj])
                pos += len(idxs)
            if not entries:
                continue
            entries.sort()
            idx = host_to_device(np.asarray([e[1] for e in entries],
                                            np.int64), cat_w.device)
            yield SealedWindow(
                words=cat_w[idx],
                tags=None if cat_t is None else cat_t[idx],
                counters=[e[2] for e in entries],
                epochs=[e[3] for e in entries],
                meta=outs[0].meta, n_words=outs[0].n_words)

    # ------------------------------------------------------ fault tolerance

    def _ft_fresh_coords(self, n: int):
        """Reserve a FRESH counter block for a re-execution.

        Every retry / failover / backup / replay re-seals its rows under
        counters reserved from the INGRESS edge at the current epoch —
        the one allocator whose blocks are collision-free across every
        edge (mid-pipeline edges never advance the session count), so a
        re-executed share can never re-spend a (key, nonce, counter)
        triple already used on any outbound key.  Plain mode has no
        nonces: returns None (re-execution keeps original coordinates).
        """
        h0 = self.keys[0]
        if h0 is None:
            return None
        base, epoch = h0.reserve_window(n)
        return (list(range(base, base + n)), epoch)

    def _ft_exec(self, st: Stage, ex: EnclaveExecutor, sub: SealedWindow,
                 coords):
        """One batched open->op->seal of a share.  ``coords`` =
        (counters, epoch) re-seals under fresh ingress-reserved
        coordinates (the re-execution path); None keeps steady state."""
        if st.fn is not None:
            return ex.run_window(st.fn, sub, reseal_as=coords)
        return ex.run_static_window(st.op, st.const, sub, reseal_as=coords)

    def _ft_pick_survivor(self, st: Stage, ft, exclude: int,
                          prefer=None) -> Optional[int]:
        """A live, not-dead worker other than ``exclude``, honouring the
        backup dispatcher's placement hint when it is usable.  Recomputed
        from the CURRENT worker set, so a spare enrolled earlier in the
        same round absorbs later failovers."""
        cands = []
        for x in range(max(1, st.workers)):
            if x == exclude or ft.is_dead(st.name, x):
                continue
            if self.directory.policy.is_revoked(self.worker_id(st.name, x)):
                continue
            cands.append(x)
        if not cands:
            return None
        if prefer is not None and prefer in cands:
            return prefer
        return cands[0]

    def enroll_spare(self, stage_name: str) -> int:
        """Enroll + admit one spare worker for a stage, live.

        The spare takes the same attested admission path as build time
        (measure -> enroll -> quote -> verify); edge sessions are
        stage-scoped, so the spare joins the existing attested channels
        (``KeyDirectory.establish`` runs only if an edge lost its
        session).  Returns the new worker index; raises
        :class:`repro_torch.attest.quote.QuoteError` if admission fails
        (a chaos-injected handshake failure included)."""
        idx, st = next((i, s) for i, s in enumerate(self.stages)
                       if s.name == stage_name)
        d = self.directory
        w = max(1, st.workers)
        wid = self.worker_id(st.name, w)
        meas = measure_stage(op=st.op, const=st.const, fn=st.fn, sgx=st.sgx)
        d.policy.allow(meas)
        d.enroll(wid, meas)
        d.admit(wid)                 # raises unless the quote verifies
        if self.secure.mode != "plain":
            endpoints = ["io/source"] \
                + [f"stage/{s.name}" for s in self.stages] + ["io/sink"]
            for e in (idx, idx + 1):
                if not d.has_session(f"edge{e}"):
                    d.establish(f"edge{e}", endpoints[e], endpoints[e + 1],
                                stage_id=e)
        st.workers = w + 1
        return w

    def _ft_enroll_spare(self, st: Stage, pool: List[EnclaveExecutor],
                         ft) -> Optional[int]:
        """Failover fallback when a stage has no survivors: enroll a
        spare through the live admission path and extend the worker
        pool.  A rejected admission (chaos ``enroll_fail``) is retried
        once; None if no spare was admitted."""
        for _ in range(2):
            try:
                w = self.enroll_spare(st.name)
            except QuoteError:
                ft.enroll_failures.inc()
                continue
            i = next(ix for ix, s in enumerate(self.stages)
                     if s.name == st.name)
            pool.append(self._executor(i, st, w))
            m = self.metrics[st.name]
            if len(m.per_worker) < len(pool):
                m.per_worker.extend([0] * (len(pool) - len(m.per_worker)))
            return w
        return None

    def _ft_dispatch_share(self, st: Stage, pool: List[EnclaveExecutor],
                           ft, rnd: int, w: int,
                           sub: SealedWindow, share_id: int):
        """Dispatch one worker share under the retry policy.

        Consults the chaos plan for crash/stall faults at this
        (stage, round, worker) hook, retries with backoff on the same
        worker, fails the share over to a survivor (or a live-enrolled
        spare) when the worker is gone, and races an injected straggler
        against a speculative backup on another worker.  EVERY
        re-execution re-seals under fresh ingress-reserved counters
        (:meth:`_ft_fresh_coords`).  The share's time ``dt`` is host
        time around an asynchronous launch (its enqueue), as the
        reference's is: the engine adds no sync to time it.  Returns
        (final worker, out window, deferred verdict vector); raises if
        the share cannot be placed anywhere."""
        audit = self.directory.audit
        policy = ft.policy
        chaos = ft.chaos
        det = ft.detector(st.name)
        bdisp = ft.dispatcher(st.name, max(1, st.workers))
        bdisp.track(share_id, w)
        attempts = 0
        fresh = False
        t_start = time.perf_counter()
        ft.shares[(st.name, rnd)] += 1
        while True:
            spec = None if chaos is None \
                else chaos.crash_for(st.name, rnd, w)
            dead = ft.is_dead(st.name, w)
            out = ok = dt = None
            if not dead and (spec is None or spec.when == "after"):
                coords = self._ft_fresh_coords(len(sub)) if fresh else None
                t0 = time.perf_counter()
                ft.executions[(st.name, rnd)] += 1
                out, ok = self._ft_exec(st, pool[w], sub, coords)
                dt = time.perf_counter() - t0
            if spec is not None:
                # the fault fires exactly once: one worker_failed per
                # injected crash, however many shares it costs
                ft.worker_failures.inc()
                audit.record("worker_failed", stage=st.name,
                             worker=self.worker_id(st.name, w),
                             reason="crash", fatal=spec.fatal, round=rnd)
                if spec.fatal:
                    ft.mark_dead(st.name, w)
            if spec is not None or dead:
                # the share (or its result) is lost
                attempts += 1
                alive = not ft.is_dead(st.name, w)
                within = attempts < policy.max_attempts and (
                    policy.deadline_s is None
                    or time.perf_counter() - t_start < policy.deadline_s)
                if alive and within:
                    ft.retries.inc()
                    audit.record("share_retried", stage=st.name,
                                 worker=self.worker_id(st.name, w),
                                 attempt=attempts, round=rnd)
                    policy.sleep(policy.backoff(attempts))
                    fresh = True
                    continue
                if not policy.failover:
                    raise KeyDirectoryError(
                        f"share of stage {st.name!r} lost worker "
                        f"{self.worker_id(st.name, w)} and failover is "
                        f"disabled by the retry policy")
                w2 = self._ft_pick_survivor(st, ft, exclude=w)
                if w2 is None and policy.enroll_spare:
                    w2 = self._ft_enroll_spare(st, pool, ft)
                if w2 is None:
                    raise KeyDirectoryError(
                        f"share of stage {st.name!r} has no survivor to "
                        f"fail over to and no spare could be admitted")
                ft.failovers.inc()
                audit.record("share_failover", stage=st.name,
                             worker=self.worker_id(st.name, w),
                             to=self.worker_id(st.name, w2),
                             reason="crash", round=rnd)
                bdisp.track(share_id, w2)
                w = w2
                attempts = 0
                fresh = True
                continue
            # success path: race an injected stall against the cutoff
            stall = None if chaos is None \
                else chaos.stall_for(st.name, rnd, w)
            if stall is not None:
                observed = dt + stall.seconds
                if observed > policy.timeout_for(det):
                    ft.worker_failures.inc()
                    audit.record("worker_failed", stage=st.name,
                                 worker=self.worker_id(st.name, w),
                                 reason="stall", round=rnd)
                    hint = bdisp.reissue(share_id)
                    w2 = self._ft_pick_survivor(st, ft, exclude=w,
                                                prefer=hint)
                    if w2 is not None:
                        # the speculative backup wins; the original
                        # result arrives late and deduplicates
                        ft.backups.inc()
                        audit.record("share_failover", stage=st.name,
                                     worker=self.worker_id(st.name, w),
                                     to=self.worker_id(st.name, w2),
                                     reason="backup", round=rnd)
                        coords = self._ft_fresh_coords(len(sub))
                        t0 = time.perf_counter()
                        ft.executions[(st.name, rnd)] += 1
                        out2, ok2 = self._ft_exec(st, pool[w2], sub,
                                                  coords)
                        det.observe(time.perf_counter() - t0)
                        bdisp.track(share_id, w2)
                        bdisp.complete(share_id)   # backup completes...
                        bdisp.complete(share_id)   # ...original is a dup
                        return w2, out2, ok2
                    # nobody to back up on: keep the slow result
                det.observe(observed)
                bdisp.complete(share_id)
                return w, out, ok
            det.observe(dt)
            bdisp.complete(share_id)
            return w, out, ok

    def _stage_stream_ft(self, upstream: Iterator[SealedWindow], st: Stage,
                         pool: List[EnclaveExecutor], window_chunks: int,
                         ft) -> Iterator[SealedWindow]:
        """Fault-tolerant sibling of :meth:`_stage_stream`.

        Same round structure (pull -> round-robin -> one batched
        dispatch per worker share -> ONE deferred-verdict host sync ->
        merge in stream order), with the fault-tolerance hooks around
        it: the round's sealed input parts are RETAINED in the replay
        buffer until its verdicts are folded in; each share goes through
        :meth:`_ft_dispatch_share` (chaos crash/stall hooks, retry,
        failover, speculative backup); tampered shares MAC-fail at the
        sync and their rows are re-executed from the retained clean
        parts; a dropped verdict sync voids the whole share, which is
        likewise replayed (with one more host sync for the replays'
        verdicts).  Replayed rows re-seal under fresh ingress counters
        and the merge still orders by original row index, so the
        surviving stream and any terminal reduce over it equal the
        fault-free run's."""
        m = self.metrics[st.name]
        if len(m.per_worker) < len(pool):
            m.per_worker.extend([0] * (len(pool) - len(m.per_worker)))
        tr = self.tracer
        audit = self.directory.audit
        chaos = ft.chaos
        secure = self.secure.mode != "plain"
        lat = _METRICS.histogram(f"pipeline.stage.{st.name}.window_seconds")
        depth = _METRICS.gauge(f"pipeline.stage.{st.name}.queue_rows")
        phase = 0
        rnd = -1
        while True:
            rnd += 1
            live = [w for w in self._live_workers(st)
                    if not ft.is_dead(st.name, w)]
            if not live:
                # every worker is dead: last-ditch live spare enrollment
                w = self._ft_enroll_spare(st, pool, ft)
                if w is None:
                    raise KeyDirectoryError(
                        f"every worker of stage {st.name!r} is dead and "
                        f"no spare could be admitted")
                live = [w]
            parts, got = self._pull_round(upstream,
                                          len(live) * window_chunks)
            if not parts:
                return
            # retain the sealed inputs (still under their reserved nonce
            # blocks) until this round's verdict sync is folded in
            ft.buffer.retain(st.name, rnd, parts)
            depth.set(got)
            tr.counter("queue_rows", got, track=st.name)
            live = [w for w in self._live_workers(st)
                    if not ft.is_dead(st.name, w)]
            L = len(live)
            d0 = _DISPATCHES.value
            t0 = time.perf_counter()
            dispatches = []          # (part idx, worker, row idxs, out, ok)
            flags = []               # aligned: per-share fault markers
            with tr.span("stage.dispatch", cat="dispatch", track=st.name,
                         rows=got, workers=L):
                for pi, win in enumerate(parts):
                    B = len(win)
                    assign = [(phase + j) % L for j in range(B)]
                    phase += B
                    for k in range(L):
                        idxs = [j for j in range(B) if assign[j] == k]
                        if not idxs:
                            continue
                        sub = win if len(idxs) == B else win.select(idxs)
                        w = live[k]
                        tampered = False
                        if secure and chaos is not None:
                            tf = chaos.tamper_for(st.name, rnd, w)
                            if tf is not None:
                                # corrupt the dispatch COPY only: the
                                # retained rows stay clean for replay
                                sub = chaos.apply_tamper(tf, sub)
                                tampered = True
                        share_id = ft.next_share_id()
                        w2, out, ok = self._ft_dispatch_share(
                            st, pool, ft, rnd, w, sub, share_id)
                        verdict_dropped = False
                        if secure and chaos is not None:
                            dv = chaos.drop_verdict_for(st.name, rnd, w)
                            verdict_dropped = dv is not None
                        dispatches.append((pi, w2, idxs, out, ok))
                        flags.append({"tampered": tampered,
                                      "verdict_dropped": verdict_dropped})
            verdicts = _sync_window(
                [d[3].words for d in dispatches],
                [(d[4], len(d[3])) for d in dispatches], self.device,
                tracer=tr, track=st.name)
            dt = time.perf_counter() - t0
            m.seconds += dt
            lat.observe(dt)
            m.windows += 1
            disp = _DISPATCHES.value - d0
            m.dispatches += disp
            tr.counter("windows_per_s", (1.0 / dt) if dt > 0 else 0.0,
                       track=st.name)
            # ---- per-row accounting + replay scheduling
            off = 0
            final = []               # dispatch tuples fed to the merge
            marks: List[np.ndarray] = []
            replays = []             # (part idx, worker, row js, reason)
            for di, (pi, w, idxs, out, _) in enumerate(dispatches):
                v = np.array(verdicts[off: off + len(idxs)], copy=True)
                off += len(idxs)
                if flags[di]["verdict_dropped"]:
                    # the host never saw this share's verdicts: every
                    # row is unverified -> replay the whole share
                    replays.append((pi, w, list(idxs), "verdict_dropped"))
                    continue
                for jj, alive_row in enumerate(v):
                    if alive_row:
                        m.chunks += 1
                        m.per_worker[w] += 1
                        m.bytes += int(parts[pi].n_words) * 4
                    else:
                        m.mac_failures += 1
                        pool[w].errors += 1
                        audit.record("mac_failure", stage=st.name,
                                     worker=self.worker_id(st.name, w),
                                     row=out.counters[jj],
                                     epoch=out.epochs[jj])
                final.append((pi, w, idxs, out, None))
                marks.append(v)
                failed_js = [j for jj, j in enumerate(idxs) if not v[jj]]
                if failed_js and secure and ft.policy.replay_mac_failures:
                    replays.append((pi, w, failed_js, "mac_failure"))
            if replays:
                rd = []
                for pi, w, row_js, reason in replays:
                    sub = parts[pi].select(row_js)
                    coords = self._ft_fresh_coords(len(sub))
                    wr = w if not ft.is_dead(st.name, w) else live[0]
                    ft.executions[(st.name, rnd)] += 1
                    out2, ok2 = self._ft_exec(st, pool[wr], sub, coords)
                    rd.append((pi, wr, row_js, out2, ok2))
                    ft.replays.inc()
                    audit.record("window_replayed", stage=st.name,
                                 worker=self.worker_id(st.name, wr),
                                 rows=len(row_js), reason=reason,
                                 round=rnd)
                rv = _sync_window([d[3].words for d in rd],
                                  [(d[4], len(d[3])) for d in rd],
                                  self.device, tracer=tr, track=st.name)
                roff = 0
                for (pi, _, row_js, reason), (_, wr, _, out2, _) \
                        in zip(replays, rd):
                    v2 = np.array(rv[roff: roff + len(row_js)], copy=True)
                    roff += len(row_js)
                    for jj, alive_row in enumerate(v2):
                        if alive_row:
                            m.chunks += 1
                            m.per_worker[wr] += 1
                            m.bytes += int(parts[pi].n_words) * 4
                        elif reason == "verdict_dropped":
                            # first time this row provably failed
                            m.mac_failures += 1
                            audit.record(
                                "mac_failure", stage=st.name,
                                worker=self.worker_id(st.name, wr),
                                row=out2.counters[jj],
                                epoch=out2.epochs[jj])
                        # a mac_failure replay that fails again was
                        # already audited on the original verdict
                    final.append((pi, wr, row_js, out2, None))
                    marks.append(v2)
            self._record_stage_window(st, parts, got, final, marks, dt, disp)
            with tr.span("stage.merge", cat="pipeline", track=st.name,
                         windows=len(parts)):
                merged = list(self._merge_outputs(parts, final, marks))
            # the round's verdicts are folded in: release retained rows
            ft.buffer.ack(st.name, rnd)
            yield from merged

    def _ingress_stream(self, source: Iterable, mode: str,
                        rekey_every_n: Optional[int],
                        window: int) -> Iterator[SealedWindow]:
        """Seal source tensors window-at-a-time with a prefetch
        double-buffer: window N+1's batched seal is dispatched BEFORE
        window N is handed downstream.  Each window reserves its
        nonce-counter blocks from the directory's managed per-edge
        counter, so a second ``run()`` continues the count instead of
        resealing under already-used (key, nonce) pairs;
        ``rekey_every_n`` keeps its per-chunk cadence (see
        :meth:`_seal_ingress_window`)."""
        it = iter(source)
        n_plain = 0
        tr = self.tracer
        mon = self.monitor
        buffered = _METRICS.gauge("pipeline.ingress.buffered_rows")
        prev: Optional[List[SealedWindow]] = None
        while True:
            xs = [as_device_tensor(x, self.device)
                  for x in itertools.islice(it, window)]
            if not xs:
                break
            d0 = _DISPATCHES.value
            t0 = time.perf_counter()
            with tr.span("ingress.seal", cat="dispatch", track="ingress",
                         rows=len(xs)):
                if mode == "plain":
                    cur = [plain_window(range(n_plain + j,
                                              n_plain + j + len(sub)), sub)
                           for j, sub in _shape_runs(xs)]
                    n_plain += len(xs)
                else:
                    cur = self._seal_ingress_window(xs, rekey_every_n)
            buffered.set(len(xs))
            disp = _DISPATCHES.value - d0
            self._ingress_windows_n += 1
            self._ingress_dispatches += disp
            if mon.enabled:
                mon.record_window(
                    "ingress", rows=len(xs),
                    bytes=sum(len(w) * int(w.n_words) * 4 for w in cur),
                    seconds=time.perf_counter() - t0, queue_rows=len(xs),
                    dispatches=disp)
            if prev is not None:
                yield from prev
            prev = cur
        if prev is not None:
            yield from prev
        buffered.set(0)

    def _seal_ingress_window(self, xs: List[torch.Tensor],
                             rekey: Optional[int]) -> List[SealedWindow]:
        """One sealed ingress window: (epoch, shape)-grouped batched seals
        over directory-reserved counter blocks, with ``advance_epoch``
        firing between groups exactly where a per-chunk engine would."""
        h0 = self.keys[0]
        wins: List[SealedWindow] = []
        i = 0
        while i < len(xs):
            sess = self.directory.session(h0.edge)
            if rekey and sess.chunks >= rekey:
                self.tracer.instant("rekey", cat="security",
                                    track="ingress",
                                    epoch=self.directory.advance_epoch())
                sess = self.directory.session(h0.edge)
            room = len(xs) - i if not rekey else max(1, rekey - sess.chunks)
            group = xs[i:i + room]
            for _, sub in _shape_runs(group):
                base, epoch = h0.reserve_window(len(sub))
                wins.append(seal_tensors_window(
                    h0, range(base, base + len(sub)), sub, epoch=epoch))
            i += len(group)
        return wins

    def _clamp_window_for_rekey(self, wc: int, rekey_every_n: int) -> int:
        """Largest safe window factor for this rekey cadence: the
        directory's ``epoch_history`` must cover the deepest in-flight
        lag (one window per stage, two ingress windows, one egress
        window).  Rejected up front if even a per-chunk engine could
        drain past history."""
        S = sum(max(1, s.workers) for s in self.stages)
        w0 = max(1, self.stages[0].workers) if self.stages else 1
        wl = max(1, self.stages[-1].workers) if self.stages else 1
        hist = self.directory.epoch_history

        seed_in_flight = S + 1              # a per-chunk engine's depth
        seed_lag = -(-seed_in_flight // rekey_every_n) + 1
        if seed_lag > hist:
            raise ValueError(
                f"rekey_every_n={rekey_every_n} can rotate "
                f"{seed_lag} epochs while up to {seed_in_flight} chunks "
                f"are in flight, but KeyDirectory(epoch_history="
                f"{hist}) would prune keys "
                f"still needed to drain — raise epoch_history or "
                f"rekey_every_n")

        def lag(w: int) -> int:
            in_flight = (S + 2 * w0 + wl) * w + 1
            return -(-in_flight // rekey_every_n) + 1

        while wc > 1 and lag(wc) > hist:
            wc -= 1
        return wc

    def run(self, source: Iterable, on_result: Optional[Callable] = None,
            rekey_every_n: Optional[int] = None,
            window_chunks: Optional[int] = None,
            tracer=None, monitor=None, retry=None, chaos=None) -> Any:
        """Stream source chunks (tensors on the pipeline's device, or
        numpy arrays) through all stages; returns the terminal reduce
        value (if the last stage reduces) or the last chunk.

        ``rekey_every_n``: rotate every edge session key after each N
        source chunks, mid-stream; chunks open under the epoch they were
        ingressed in, and the window factor is clamped so the
        directory's ``epoch_history`` covers the deepest in-flight lag.
        ``window_chunks`` overrides the pipeline's window factor for this
        run; 1 is the per-chunk oracle engine.

        ``tracer`` / ``monitor``: a :class:`repro_torch.obs.Tracer` /
        :class:`repro_torch.obs.PipelineMonitor` for this run only (the
        pipeline's own otherwise); output, host syncs and dispatches are
        the same with or without them.

        ``retry``: a :class:`repro_torch.ft.RetryPolicy` enabling
        per-share retry, failover and replay for this run only (the
        window engine only: ``ValueError`` when the window factor
        resolves to 1).  ``chaos``: a :class:`repro_torch.ft.ChaosPlan`
        of seeded faults consulted at every engine hook; it implies the
        default policy when no ``retry`` is given, and its
        ``enroll_fail`` faults go through the directory's admission
        interceptor for the run."""
        prev = (self.tracer, self.monitor, self.retry, self.chaos,
                self.directory.admission_interceptor)
        if tracer is not None:
            self.tracer = tracer
        if monitor is not None:
            self.monitor = monitor
            monitor.attach(self)
        if retry is not None:
            self.retry = retry
        if chaos is not None:
            self.chaos = chaos
        if self.chaos is not None:
            self.directory.admission_interceptor = self.chaos.enroll_failure
        try:
            with self.tracer.span("pipeline.run", mode=self.secure.mode,
                                  stages=len(self.stages)):
                return self._run_impl(source, on_result, rekey_every_n,
                                      window_chunks)
        finally:
            (self.tracer, self.monitor, self.retry, self.chaos,
             self.directory.admission_interceptor) = prev

    def _run_impl(self, source: Iterable, on_result: Optional[Callable],
                  rekey_every_n: Optional[int],
                  window_chunks: Optional[int]) -> Any:
        mode = self.secure.mode
        wc = self.window_chunks if window_chunks is None \
            else max(1, int(window_chunks))
        if rekey_every_n and mode != "plain":
            wc = self._clamp_window_for_rekey(wc, rekey_every_n)
        ft = None
        if self.retry is not None or self.chaos is not None:
            ft = FTContext(policy=self.retry if self.retry is not None
                           else RetryPolicy(), chaos=self.chaos)
        self._last_ft = ft
        if wc == 1:
            if ft is not None:
                raise ValueError(
                    "fault tolerance (retry/chaos) needs the "
                    "window-vectorized engine (window_chunks >= 2); the "
                    "window factor resolved to 1 — if rekey_every_n "
                    "clamped it, build the pipeline with a "
                    "KeyDirectory(epoch_history=...) large enough for "
                    "the window/rekey combination")
            # the per-chunk oracle engine: scalar seal/open per chunk with
            # a blocking verdict sync per chunk (the seed engine)
            return self._run_chunked(source, on_result, rekey_every_n)
        w0 = max(1, self.stages[0].workers) if self.stages else 1
        stream: Iterator[SealedWindow] = self._ingress_stream(
            source, mode, rekey_every_n, w0 * wc)

        # compose map/filter stages up to the terminal reduce (if any)
        reduce_idx = next((i for i, s in enumerate(self.stages)
                           if s.reduce_fn is not None), None)
        end = len(self.stages) if reduce_idx is None else reduce_idx
        for i in range(end):
            st = self.stages[i]
            pool = self._worker_pool(i, st)
            if ft is not None:
                stream = self._stage_stream_ft(stream, st, pool, wc, ft)
            else:
                stream = self._stage_stream(stream, st, pool, wc)
        sink_w = max(1, self.stages[end - 1].workers) if end else 1
        egress_rows = sink_w * wc
        audit = self.directory.audit
        egress_lat = _METRICS.histogram("pipeline.egress.window_seconds")

        if reduce_idx is not None:
            # terminal reduce: decrypt at the sink edge (trusted
            # subscriber) a window at a time and fold in stream order
            st = self.stages[reduce_idx]
            m = self.metrics[st.name]
            reduce_state: Any = None
            reduce_started = False
            for groups, verdicts, dt in self._egress_windows(
                    stream, mode, self.keys[reduce_idx], egress_rows):
                egress_lat.observe(dt)
                t0 = time.perf_counter()
                with self.tracer.span("reduce.fold", cat="pipeline",
                                      track="sink", rows=len(verdicts)):
                    off = 0
                    for win, vals in groups:
                        for j in range(len(win)):
                            if not verdicts[off + j]:
                                m.mac_failures += 1
                                audit.record("mac_failure", stage=st.name,
                                             worker="io/sink",
                                             row=win.counters[j],
                                             epoch=win.epochs[j])
                                continue
                            if not reduce_started:
                                reduce_state = st.reduce_init
                                reduce_started = True
                            reduce_state = st.reduce_fn(reduce_state,
                                                        vals[j])
                            m.chunks += 1
                            m.bytes += int(win.n_words) * 4
                        off += len(win)
                m.seconds += dt + (time.perf_counter() - t0)
            return _finish(st.reduce_fn, reduce_state) \
                if reduce_started else None

        final = None
        for groups, verdicts, dt in self._egress_windows(
                stream, mode, self.keys[len(self.stages)], egress_rows):
            egress_lat.observe(dt)
            off = 0
            for win, vals in groups:
                for j in range(len(win)):
                    final = vals[j]
                    if not verdicts[off + j]:
                        audit.record("mac_failure", stage="egress",
                                     worker="io/sink",
                                     row=win.counters[j],
                                     epoch=win.epochs[j])
                    elif on_result is not None:
                        on_result(vals[j])
                off += len(win)
        return final

    def _egress_windows(self, stream: Iterator[SealedWindow], mode: str,
                        key, window: int):
        """Open the terminal stream a window at a time (one ``open_many``
        per framing-uniform window, ONE host sync per window).  Yields
        ([(window, opened tensor batch)], verdicts, seconds)."""
        parts: List[SealedWindow] = []
        got = 0
        for win in stream:
            parts.append(win)
            got += len(win)
            if got >= window:
                yield self._open_egress(parts, mode, key)
                parts, got = [], 0
        if parts:
            yield self._open_egress(parts, mode, key)

    def _open_egress(self, parts: List[SealedWindow], mode: str, key):
        d0 = _DISPATCHES.value
        t0 = time.perf_counter()
        groups = []
        specs = []
        with self.tracer.span("egress.open", cat="dispatch", track="sink",
                              rows=sum(len(w) for w in parts)):
            for win in parts:
                vals, ok = egress_window(mode, key, win)
                groups.append((win, vals))
                specs.append((ok, len(win)))
        verdicts = _sync_window([v for _, v in groups], specs, self.device,
                                tracer=self.tracer, track="sink")
        dt = time.perf_counter() - t0
        disp = _DISPATCHES.value - d0
        self._egress_windows_n += 1
        self._egress_dispatches += disp
        mon = self.monitor
        if mon.enabled:
            mon.record_window(
                "egress", rows=sum(len(w) for w in parts),
                ok_rows=int(verdicts.sum()),
                bytes=sum(len(w) * int(w.n_words) * 4 for w in parts),
                seconds=dt, dispatches=disp)
        return groups, verdicts, dt

    # ------------------------------------- per-chunk oracle (window_chunks=1)

    def _ingress_stream_chunked(self, source: Iterable, mode: str,
                                rekey_every_n: Optional[int]
                                ) -> Iterator[SealedChunk]:
        """Scalar per-chunk ingress (the oracle engine): one seal and one
        managed counter per chunk, rekey checked per chunk."""
        n_plain = 0
        for x in source:
            x = as_device_tensor(x, self.device)
            if mode == "plain":
                yield ingress(mode, None, n_plain, x)
                n_plain += 1
                continue
            h0 = self.keys[0]
            if rekey_every_n and \
                    self.directory.session(h0.edge).chunks >= rekey_every_n:
                self.tracer.instant("rekey", cat="security",
                                    track="ingress",
                                    epoch=self.directory.advance_epoch())
            yield ingress(mode, h0, h0.next_counter(), x)

    def _stage_stream_chunked(self, upstream: Iterator[SealedChunk],
                              st: Stage, pool: List[EnclaveExecutor]
                              ) -> Iterator[SealedChunk]:
        """The per-chunk oracle: scalar open->op->seal per chunk with a
        blocking host sync for each verdict — round-robin dispatch over
        the live workers, fair-queue merge of the worker sub-streams.
        Each chunk counts as one window of the stage."""
        m = self.metrics[st.name]
        if len(m.per_worker) < len(pool):
            m.per_worker.extend([0] * (len(pool) - len(m.per_worker)))
        tr = self.tracer
        mon = self.monitor
        audit = self.directory.audit
        lat = _METRICS.histogram(f"pipeline.stage.{st.name}.window_seconds")
        while True:
            live = self._live_workers(st)
            window = list(itertools.islice(upstream, len(live)))
            if not window:
                return
            worker_outs: List[List[SealedChunk]] = []
            for k, queue in enumerate(R.round_robin(window, len(live))):
                w = live[k]
                outs: List[SealedChunk] = []
                for chunk in queue:
                    d0 = _DISPATCHES.value
                    t0 = time.perf_counter()
                    with tr.span("stage.chunk", cat="dispatch",
                                 track=f"{st.name}/w{w}",
                                 row=chunk.counter):
                        if st.fn is not None:
                            out = pool[w].run(st.fn, chunk)
                        else:
                            out = pool[w].run_static(st.op, st.const, chunk)
                    if pool[w].mode != "plain":
                        _HOST_SYNCS.inc()      # the scalar bool(ok) sync
                    dt = time.perf_counter() - t0
                    m.seconds += dt
                    lat.observe(dt)            # the oracle's window IS a chunk
                    m.windows += 1
                    disp = _DISPATCHES.value - d0
                    m.dispatches += disp
                    if mon.enabled:
                        mon.record_window(
                            st.name, rows=1,
                            ok_rows=0 if out is None else 1,
                            bytes=0 if out is None
                            else int(chunk.n_words) * 4,
                            seconds=dt, queue_rows=len(window),
                            worker_rows={w: 1}, min_epoch=chunk.epoch,
                            dispatches=disp)
                    if out is None:
                        m.mac_failures += 1
                        audit.record("mac_failure", stage=st.name,
                                     worker=self.worker_id(st.name, w),
                                     row=chunk.counter, epoch=chunk.epoch)
                        continue
                    m.chunks += 1
                    m.per_worker[w] += 1
                    m.bytes += int(chunk.n_words) * 4
                    outs.append(out)
                worker_outs.append(outs)
            yield from R.fair_queue(worker_outs)

    def _run_chunked(self, source: Iterable, on_result: Optional[Callable],
                     rekey_every_n: Optional[int]) -> Any:
        """The original streaming engine, chunk by chunk (the
        ``window_chunks=1`` degenerate case)."""
        mode = self.secure.mode
        audit = self.directory.audit
        stream: Iterator[SealedChunk] = self._ingress_stream_chunked(
            source, mode, rekey_every_n)
        reduce_idx = next((i for i, s in enumerate(self.stages)
                           if s.reduce_fn is not None), None)
        end = len(self.stages) if reduce_idx is None else reduce_idx
        for i in range(end):
            st = self.stages[i]
            stream = self._stage_stream_chunked(stream, st,
                                                self._worker_pool(i, st))

        if reduce_idx is not None:
            st = self.stages[reduce_idx]
            m = self.metrics[st.name]
            reduce_state: Any = None
            reduce_started = False
            for chunk in stream:
                t0 = time.perf_counter()
                val, ok = egress(mode, self.keys[reduce_idx], chunk)
                if mode != "plain":
                    _HOST_SYNCS.inc()
                if not bool(ok):
                    m.mac_failures += 1
                    audit.record("mac_failure", stage=st.name,
                                 worker="io/sink", row=chunk.counter,
                                 epoch=chunk.epoch)
                    continue
                if not reduce_started:
                    reduce_state = st.reduce_init
                    reduce_started = True
                reduce_state = st.reduce_fn(reduce_state, val)
                m.chunks += 1
                m.bytes += int(chunk.n_words) * 4
                m.seconds += time.perf_counter() - t0
            return _finish(st.reduce_fn, reduce_state) \
                if reduce_started else None

        final = None
        for chunk in stream:
            result, ok = egress(mode, self.keys[len(self.stages)], chunk)
            if mode != "plain":
                _HOST_SYNCS.inc()
            final = result
            if not bool(ok):
                audit.record("mac_failure", stage="egress",
                             worker="io/sink", row=chunk.counter,
                             epoch=chunk.epoch)
            elif on_result is not None:
                on_result(result)
        return final

    # ------------------------------------------------------------- elastic

    def scale_stage(self, name: str, workers: int) -> "Pipeline":
        """Elastic scaling: change a stage's worker count (paper §5.5).
        The KeyDirectory (sessions, epoch, revocations), the seed, the
        device and the accumulated metrics carry forward, so the stream
        is not re-keyed and reports stay continuous."""
        stages = [
            Stage(**{**s.__dict__, "workers": workers}) if s.name == name
            else s for s in self.stages
        ]
        p = Pipeline(stages, self.secure, seed=self.seed,
                     directory=self.directory,
                     window_chunks=self.window_chunks, fusion=self.fusion,
                     device=self.device,
                     tracer=None if self.tracer is NULL_TRACER
                     else self.tracer,
                     monitor=None if self.monitor is NULL_MONITOR
                     else self.monitor)
        p._evicted_logged = self._evicted_logged
        p._ingress_windows_n = self._ingress_windows_n
        p._ingress_dispatches = self._ingress_dispatches
        p._egress_windows_n = self._egress_windows_n
        p._egress_dispatches = self._egress_dispatches
        for sname, m in self.metrics.items():
            pw = list(m.per_worker)
            if sname == name and len(pw) < workers:
                pw.extend([0] * (workers - len(pw)))
            p.metrics[sname] = dataclasses.replace(m, per_worker=pw)
        return p

    def report(self) -> Dict[str, Dict[str, Any]]:
        """Per-stage metrics dict (chunks, bytes, seconds, MB/s, MAC
        failures, per-worker counts, windows, dispatches), the audit
        summary, and the ingress/egress dispatch accounting.  Stages the
        DSL compiler merged carry a ``fused_from`` list, and a top-level
        ``"fusion"`` entry logs every fusion decision (taken or
        declined) — both absent for hand-built pipelines."""
        fused_from = self.fusion.get("fused_from", {})
        out: Dict[str, Dict[str, Any]] = {
            name: {"chunks": m.chunks, "bytes": m.bytes,
                   "seconds": round(m.seconds, 4),
                   "throughput_mbps": None if m.throughput_mbps is None
                   else round(m.throughput_mbps, 2),
                   "mac_failures": m.mac_failures,
                   "mac_failure_rate": None if m.mac_failure_rate is None
                   else round(m.mac_failure_rate, 4),
                   "per_worker": list(m.per_worker),
                   "windows": m.windows,
                   "dispatches": m.dispatches,
                   "dispatches_per_window":
                   None if m.dispatches_per_window is None
                   else round(m.dispatches_per_window, 4),
                   **({"fused_from": list(fused_from[name])}
                      if name in fused_from else {})}
            for name, m in self.metrics.items()
        }
        if self.fusion.get("decisions"):
            out["fusion"] = {"decisions": list(self.fusion["decisions"])}
        out["audit"] = self.directory.audit.summary()
        out["dispatch"] = {
            "total": self._ingress_dispatches + self._egress_dispatches
            + sum(m.dispatches for m in self.metrics.values()),
            "ingress": {"windows": self._ingress_windows_n,
                        "dispatches": self._ingress_dispatches},
            "egress": {"windows": self._egress_windows_n,
                       "dispatches": self._egress_dispatches},
        }
        return out
