"""The torch port's engines on the DelayedFlights job (paper §5.2)
against the JAX reference and a plain numpy computation, on the CPU.

The same records (``flight_records(seed=1)``, identical in both packages)
go through the reference's ``Pipeline`` and the port's; the terminal
reduce must be identical in every mode, with one or two workers per
stage, and under ``rekey_every_n=3`` plus a mid-stream revocation.  A
window factor of 1 (asked for, or forced by a tight rekey cadence) runs
the per-chunk oracle engine in both packages; those runs use a short
stream, since the reference's oracle is slow on the CPU, and are in
``tests/test_torch_pipeline_oracle.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.configs.base import SecureStreamConfig as JConfig
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro.data.synthetic import flight_records as j_flight_records
from repro.dsl.reducers import resolve_reducer as j_resolve_reducer
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.data.synthetic import flight_chunks, flight_records
from repro_torch.dsl.reducers import resolve_reducer
from _torch_threads import one_torch_thread  # noqa: F401

RECORDS = 4096
CHUNK = 256
SHORT = 1024                  # 4 chunks: the oracle-engine comparisons
MODES = ("plain", "encrypted", "enclave")


def _port(mode, workers, **kw):
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    return Pipeline([
        Stage("sgx_mapper", op="identity", workers=workers),
        Stage("sgx_filter", op="delay_filter_u32", const=15,
              workers=workers),
        Stage("reducer", op="custom", reduce_fn=fn, reduce_init=init),
    ], SecureStreamConfig(mode=mode), device="cpu", **kw)


def _jax(mode, workers, **kw):
    fn, init = j_resolve_reducer("carrier_delay_stats")
    return JPipeline([
        JStage("sgx_mapper", op="identity", workers=workers),
        JStage("sgx_filter", op="delay_filter_u32", const=15,
               workers=workers),
        JStage("reducer", op="custom", reduce_fn=fn, reduce_init=init),
    ], JConfig(mode=mode), **kw)


def _numpy():
    recs = flight_records(RECORDS, seed=1)
    keep = recs[:, 1] > 15
    return (np.bincount(recs[keep, 0], minlength=20).astype(np.float64),
            np.bincount(recs[keep, 0], weights=recs[keep, 1]
                        .astype(np.float64), minlength=20))


def _as_np(out):
    return out["count"].numpy(), out["sum"].numpy()


def _short():
    return flight_chunks(SHORT, CHUNK, seed=1)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.fixture(scope="module")
def reference():
    """JAX terminal reduces, one run per mode (one worker per stage)."""
    assert np.array_equal(flight_records(RECORDS, seed=1),
                          j_flight_records(RECORDS, seed=1))
    out = {}
    for mode in MODES:
        res = _jax(mode, 1).run(jnp.asarray(c) for c in
                                flight_chunks(RECORDS, CHUNK, seed=1))
        out[mode] = (np.asarray(res["count"]), np.asarray(res["sum"]))
    return out


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_delayed_flights_equals_reference_and_numpy(reference, mode,
                                                    workers):
    got = _as_np(_port(mode, workers).run(
        flight_chunks(RECORDS, CHUNK, seed=1)))
    want = _numpy()
    for g, j, n in zip(got, reference[mode], want):
        assert np.array_equal(g, j) and np.array_equal(g, n)


@pytest.mark.parametrize("mode", ["encrypted", "enclave"])
def test_rekey_and_revocation_match_static_keys(reference, mode):
    p = _port(mode, 2)

    def source():
        for i, c in enumerate(flight_chunks(RECORDS, CHUNK, seed=1)):
            if i == 7:
                p.directory.revoke(Pipeline.worker_id("sgx_mapper", 1))
            yield c

    got = _as_np(p.run(source(), rekey_every_n=3))
    for g, j in zip(got, reference[mode]):
        assert np.array_equal(g, j)
    audit = p.directory.audit.summary()
    assert audit["rekey"] >= 4 and audit["revocation"] == 1
    assert audit["eviction"] == 1
    rep = p.report()
    assert rep["sgx_mapper"]["per_worker"][1] < \
        rep["sgx_mapper"]["per_worker"][0]          # w1 stopped mid-stream


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ = Pipeline([Stage("m", op="identity")],
                     SecureStreamConfig(mode="plain"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline_mod.resolve_device("cuda")


def test_custom_fn_stage_and_scale_stage_keep_results():
    """A custom (closure) stage in encrypted mode, then a rescale that
    carries the directory and metrics forward."""
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    p = Pipeline([Stage("m", op="custom", fn=lambda x: x),
                  Stage("f", op="delay_filter_u32", const=15),
                  Stage("r", op="custom", reduce_fn=fn, reduce_init=init)],
                 SecureStreamConfig(mode="encrypted"), device="cpu")
    got = _as_np(p.run(flight_chunks(RECORDS, CHUNK, seed=1)))
    for g, n in zip(got, _numpy()):
        assert np.array_equal(g, n)
    p2 = p.scale_stage("f", 2)
    assert p2.directory is p.directory
    assert p2.metrics["f"].chunks == RECORDS // CHUNK
    assert len(p2.metrics["f"].per_worker) == 2
    with pytest.raises(ValueError, match="no-dynamic-linking"):
        _ = Pipeline([Stage("m", op="custom", fn=lambda x: x)],
                     SecureStreamConfig(mode="enclave"), device="cpu") \
            .run(flight_chunks(RECORDS, CHUNK, seed=1))


def test_directory_is_deterministic_like_the_reference():
    """Same seed -> same session keys, transcripts, ratchets, counters."""
    from repro_torch.attest.directory import KeyDirectory
    from repro_torch.attest.measure import IO_ENDPOINT
    from repro.attest.measure import IO_ENDPOINT as J_IO
    d, jd = KeyDirectory(seed=5), JKeyDirectory(seed=5)
    for dd, io in ((d, IO_ENDPOINT), (jd, J_IO)):
        dd.enroll("a", io, allow=True)
        dd.enroll("b", io, allow=True)
        dd.establish("e", "a", "b", stage_id=3)
    assert d.session("e").transcript == jd.session("e").transcript
    assert np.array_equal(d.edge_key("e").key.view(np.uint32),
                          jd.edge_key("e").key)
    assert d.handle("e").reserve_window(4) == jd.handle("e").reserve_window(4)
    assert d.advance_epoch() == jd.advance_epoch() == 1
    assert np.array_equal(d.edge_key("e").key.view(np.uint32),
                          jd.edge_key("e").key)
    assert d.quote_for("a").signature == jd.quote_for("a").signature
    assert d.revoke("a") == jd.revoke("a") == ["e"]
