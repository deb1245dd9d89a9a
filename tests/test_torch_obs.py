"""The port's span tracer, live monitor and exporters against the JAX
reference, on the CPU.

The reference's traced 8-stage rekey + revocation run
(``tests/test_obs.py``) goes through both packages on the same numpy
records: the port's output is bit-equal traced and untraced, and both
packages record the same multiset of spans (name, category, track) with
the same nesting, the same counter samples and the same audit stream.
Under an injected clock the port's monitor snapshot equals the
reference's on the same run.  Tracing and monitoring add no host sync
and no device program.  The reference runs in encrypted mode (its jitted
AEAD), so the file stays cheap."""
import collections
import importlib.util
import json
import pathlib
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.configs.base import SecureStreamConfig as JConfig
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro.obs import (PipelineMonitor as JPipelineMonitor,
                       REGISTRY as J_REGISTRY, Tracer as JTracer)
from repro_torch.attest.directory import KeyDirectory
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.obs import (NULL_MONITOR, NULL_TRACER, REGISTRY, AuditLog,
                             PipelineMonitor, SLORule, Tracer, Watchdog,
                             prometheus_text, serve_metrics, snapshot_json)
from repro_torch.obs.trace import _NOOP_SPAN

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "check_prometheus", ROOT / "scripts" / "check_prometheus.py")
check_prometheus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_prometheus)

N_CHUNKS = 9
REVOKE_AT = 4


class StepClock:
    """A monitor clock that advances one second per reading: the same
    sequence of readings in both packages gives the same timestamps."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        self.t += 1.0
        return self.t


def _records(n=N_CHUNKS):
    return [np.random.default_rng(i).standard_normal((64,))
            .astype(np.float32) for i in range(n)]


def _stage8(cls):
    return [cls(f"s{i}", op="scale_f32", const=1.0 + 0.125 * i,
                workers=2 if i % 3 == 0 else 1) for i in range(8)]


def _run_8stage(port, mode="encrypted", tracer=None, monitor=None):
    """The reference's acceptance run: 8 stages, ``rekey_every_n=3`` and
    a revocation of s3/w1 before chunk 4.  -> (pipeline, outputs as
    numpy arrays)."""
    if port:
        REGISTRY.reset()
        p = Pipeline(_stage8(Stage), SecureStreamConfig(mode=mode),
                     directory=KeyDirectory(seed=0, epoch_history=64),
                     window_chunks=8, device="cpu")
        chunks = [torch.as_tensor(c) for c in _records()]
    else:
        J_REGISTRY.reset()
        p = JPipeline(_stage8(JStage), JConfig(mode=mode),
                      directory=JKeyDirectory(seed=0, epoch_history=64),
                      window_chunks=8)
        chunks = [jnp.asarray(c) for c in _records()]

    def source():
        for i, c in enumerate(chunks):
            if i == REVOKE_AT:
                p.directory.revoke(p.worker_id("s3", 1))
            yield c

    got = []
    p.run(source(), on_result=lambda r: got.append(np.asarray(r)),
          rekey_every_n=3, tracer=tracer, monitor=monitor)
    return p, got


def _span_shape(tr):
    """The multiset of (name, cat, track, parent's name) and of counter
    samples (name, track): what a timeline shows, minus the times."""
    spans = collections.Counter(
        (s.name, s.cat, s.track,
         None if s.parent is None else tr.spans[s.parent].name)
        for s in tr.spans)
    counters = collections.Counter((c.name, c.track) for c in tr.counters)
    return spans, counters


@pytest.fixture(scope="module")
def reference():
    """The reference's traced run and its monitored run (StepClock)."""
    tr = JTracer()
    jp, jgot = _run_8stage(False, tracer=tr)
    mon = JPipelineMonitor(clock=StepClock())
    _run_8stage(False, monitor=mon)
    return {"tracer": tr, "pipeline": jp, "out": jgot,
            "snapshot": mon.snapshot()}


def test_traced_8stage_rekey_revocation_matches_reference(reference,
                                                          tmp_path):
    _, bare = _run_8stage(True)
    tr = Tracer()
    p, got = _run_8stage(True, tracer=tr)
    # tracing changes no bit of the stream, and the stream is the
    # reference's
    assert len(got) == len(bare) == len(reference["out"]) == N_CHUNKS
    for a, b, j in zip(got, bare, reference["out"]):
        assert np.array_equal(a, b) and np.array_equal(a, j)
    # the same spans, counters and nesting as the reference's run
    jtr = reference["tracer"]
    assert _span_shape(tr) == _span_shape(jtr)
    parents = {tr.spans[s.parent].name for s in tr.find("enclave.open")}
    assert parents == {"stage.dispatch"}
    assert len(tr.find("rekey")) == p.directory.epoch >= 2
    assert {s.track for s in tr.find("stage.dispatch")} == \
        {f"s{i}" for i in range(8)}
    # the audit stream, kind by kind and detail by detail
    assert p.directory.audit.dump() == \
        reference["pipeline"].directory.audit.dump()
    # the Chrome export loads, with every lane named
    path = tmp_path / "trace.json"
    doc = tr.export_chrome(str(path))
    assert json.loads(path.read_text()) == doc
    phs = {e["ph"] for e in doc["traceEvents"]}
    assert {"X", "M", "i", "C"} <= phs
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"ingress", "sink", "s3/w0", "s0/w1"} <= lanes
    assert "sync.verdicts" in tr.timeline()


def _without_wall_time(snap):
    """A snapshot minus what the host's clock measures (each window's
    seconds: p50/p95) and the process-wide fault-tolerance totals
    (present once any run in the process made an FTContext)."""
    snap = json.loads(json.dumps(snap))
    for st in snap["stages"].values():
        st.pop("p50_s")
        st.pop("p95_s")
    snap["pipeline"].pop("ft", None)
    return snap


def test_monitor_snapshot_equals_reference_under_injected_clock(reference):
    mon = PipelineMonitor(clock=StepClock())
    _run_8stage(True, monitor=mon)
    snap = mon.snapshot()
    assert set(snap["stages"]) == {f"s{i}" for i in range(8)} \
        | {"ingress", "egress"}
    assert snap["pipeline"]["rekey_per_s"] > 0
    assert snap["pipeline"]["revocation_per_s"] > 0
    assert _without_wall_time(snap) == \
        _without_wall_time(reference["snapshot"])


@pytest.mark.parametrize("mode", ["encrypted", "enclave"])
def test_observation_adds_no_host_sync_and_no_dispatch(mode):
    """Host syncs and device programs per window read the same bare and
    traced + monitored, and so does every output bit."""
    pipeline_mod.reset_host_sync_count()
    p, bare = _run_8stage(True, mode=mode)
    syncs, rep = pipeline_mod.host_sync_count(), p.report()
    pipeline_mod.reset_host_sync_count()
    p2, got = _run_8stage(True, mode=mode, tracer=Tracer(),
                          monitor=PipelineMonitor())
    assert pipeline_mod.host_sync_count() == syncs > 0
    rep2 = p2.report()
    assert rep2["dispatch"] == rep["dispatch"]
    for i in range(8):
        for key in ("windows", "dispatches", "dispatches_per_window"):
            assert rep2[f"s{i}"][key] == rep[f"s{i}"][key]
    for a, b in zip(got, bare):
        assert np.array_equal(a, b)


def test_prometheus_text_validates_and_has_stage_series():
    mon = PipelineMonitor()
    _run_8stage(True, monitor=mon)
    text = prometheus_text(REGISTRY, mon)
    assert check_prometheus.validate(
        text, require_labels=(("stage", "s3"), ("stage", "ingress"),
                              ("stage", "egress")), min_samples=20) == []
    assert 'repro_stage_windows_per_second{stage="s0"}' in text
    assert "repro_pipeline_host_syncs" in text
    doc = json.loads(json.dumps(snapshot_json(mon)))
    assert doc["monitor"]["stages"]["s0"]["windows_total"] >= 1


def test_metrics_server_serves_metrics_health_snapshot():
    mon = PipelineMonitor()
    _run_8stage(True, monitor=mon)
    Watchdog(mon, [SLORule("q", stage="s0", max_queue_rows=4)],
             audit=AuditLog())
    with serve_metrics(0, monitor=mon) as srv:
        assert srv.port != 0
        body = urllib.request.urlopen(srv.url + "/metrics").read().decode()
        assert check_prometheus.validate(
            body, require_labels=(("stage", "s0"),)) == []
        health = json.load(urllib.request.urlopen(srv.url + "/health"))
        assert health["status"] == "degraded"      # s0 queues 9 rows > 4
        assert health["breached"] == ["q"]
        snap = json.load(urllib.request.urlopen(srv.url + "/snapshot"))
        assert snap["monitor"]["watchdog"]["breached"] == ["q"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope")


def test_injected_mac_failure_burst_trips_watchdog_once(monkeypatch):
    """Rows tampered on s1's output fail at s2: the watchdog trips once,
    with its ``slo_breach`` event in the pipeline's own audit stream."""
    tamper = {1, 3, 6}
    pending = set(tamper)
    orig_pool = Pipeline._worker_pool

    def patched_pool(self, i, st):
        pool = orig_pool(self, i, st)
        if st.name != "s1":
            return pool
        for ex in pool:
            def tampered(op, const, win, _orig=ex.run_static_window):
                out, ok = _orig(op, const, win)
                hit = [j for j, c in enumerate(out.counters)
                       if c in pending]
                if hit:
                    pending.difference_update(out.counters[j] for j in hit)
                    words = out.words.clone()
                    for j in hit:             # flip one word, keep the tag
                        words[j, 0] += 1
                    out = type(out)(words, out.tags, out.counters,
                                    out.epochs, out.meta, out.n_words)
                return out, ok

            ex.run_static_window = tampered
        return pool

    monkeypatch.setattr(Pipeline, "_worker_pool", patched_pool)
    mon = PipelineMonitor()
    fired = []
    wd = Watchdog(mon, [SLORule("mac-ceiling", max_mac_failure_rate=0.1)],
                  on_breach=[fired.append])
    d = KeyDirectory(seed=0)
    p = Pipeline([Stage(f"s{i}", op="scale_f32", const=1.01)
                  for i in range(4)], SecureStreamConfig(mode="encrypted"),
                 directory=d, window_chunks=8, monitor=mon, device="cpu")
    got = []
    p.run(iter(torch.as_tensor(c) for c in _records()),
          on_result=lambda r: got.append(r))
    assert not pending and len(got) == N_CHUNKS - len(tamper)
    assert [b.rule for b in fired] == ["mac-ceiling"]      # exactly once
    assert fired[0].kind == "slo_breach" and fired[0].stage == "s2"
    breaches = d.audit.events("slo_breach")
    assert len(breaches) == 1
    assert breaches[0].detail["metric"] == "mac_failure_rate"
    assert d.audit.counts()["mac_failure"] == len(tamper)
    assert wd.breached() == ["mac-ceiling"]
    assert mon.stage_stats("s2")["mac_failures"] == len(tamper)


def test_oracle_engine_is_traced_and_monitored():
    """``window_chunks=1``: one ``stage.chunk`` span on the worker's lane
    and one monitor window a chunk, two host syncs a chunk (the stage's
    verdict and the sink's), as the reference's oracle engine records
    them (``tests/test_obs.py``, ``tests/test_monitor.py``)."""
    tr, mon = Tracer(), PipelineMonitor()
    p = Pipeline([Stage("s0", op="scale_f32", const=1.5)],
                 SecureStreamConfig(mode="encrypted"),
                 directory=KeyDirectory(seed=0), window_chunks=1,
                 monitor=mon, device="cpu")
    pipeline_mod.reset_host_sync_count()
    got = []
    p.run((torch.as_tensor(c) for c in _records(3)),
          on_result=lambda r: got.append(r), tracer=tr)
    assert len(got) == 3
    assert pipeline_mod.host_sync_count() == 6
    spans, _ = _span_shape(tr)
    assert spans == {("pipeline.run", "pipeline", "main", None): 1,
                     ("stage.chunk", "dispatch", "s0/w0", "pipeline.run"): 3}
    assert mon.stage_stats("s0")["windows_total"] == 3
    assert p.report()["s0"]["windows"] == 3
    assert p.directory.audit.counts()["mac_failure"] == 0


def test_dsl_trace_and_monitor_verbs_and_run_override():
    from repro_torch.dsl import stream
    src = [torch.as_tensor(c) for c in _records(8)]
    sb = (stream(src).map("scale_f32", const=1.25, name="m", workers=2)
          .secure("encrypted").window(4).device("cpu").trace().monitor())
    assert sb.tracer is not None and sb.tracer.enabled
    assert sb.health_monitor is not None and sb.health_monitor.enabled
    got = []
    sb.run(on_result=lambda r: got.append(r))
    assert len(got) == len(src)
    assert sb.tracer is sb.pipeline.tracer
    assert sb.tracer.find("stage.dispatch")
    assert sb.health_monitor.snapshot()["stages"]["m"]["windows_total"] == 1
    assert REGISTRY.get("pipeline.stage.m.window_seconds").count >= 1
    # a run's own tracer and monitor, restored afterwards
    p = sb.pipeline
    tr2, mon2 = Tracer(), PipelineMonitor()
    p.run(iter(src), tracer=tr2, monitor=mon2)
    assert tr2.find("stage.dispatch")
    assert mon2.snapshot()["stages"]["m"]["windows_total"] == 1
    assert p.tracer is sb.tracer and p.monitor is sb.health_monitor
    # unobserved builders and pipelines stay on the zero-cost defaults
    plain = stream(src).map("identity")
    assert plain.tracer is None and plain.health_monitor is None
    bare = Pipeline([Stage("m", op="identity")],
                    SecureStreamConfig(mode="plain"), device="cpu")
    assert bare.tracer is NULL_TRACER and bare.monitor is NULL_MONITOR
    assert NULL_TRACER.span("x", rows=1) is _NOOP_SPAN
    assert NULL_MONITOR.snapshot()["stages"] == {}
    # scale_stage carries the observers over
    assert p.scale_stage("m", 3).tracer is sb.tracer
