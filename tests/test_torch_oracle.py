"""The per-chunk oracle engine of the torch port (``window_chunks=1``)
against the JAX reference's, its window engine and numpy on the CPU, bit
for bit (under rekey + revocation: ``tests/test_torch_oracle_rekey.py``;
the paths it runs on: ``tests/test_torch_chunk_paths.py``).

The same records and keys (``flight_records(seed=1)`` and
``KeyDirectory(seed=...)`` are identical in both packages) go through
both; the reference's oracle seals eagerly per chunk and is slow on the
CPU, so the streams here are a few chunks of 64 records."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SecureStreamConfig as JConfig
from repro.core import pipeline as j_pipeline
from repro.dsl.reducers import resolve_reducer as j_resolve_reducer
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import enclave
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.data.synthetic import flight_chunks, flight_records
from repro_torch.dsl.reducers import resolve_reducer
from _torch_threads import one_torch_thread  # noqa: F401

RECORDS = 192
CHUNK = 64                      # 3 chunks of 64 records (1024 words)
MODES = ("plain", "encrypted", "enclave")


def _stages(mod_stage, fn, init, workers):
    return [mod_stage("sgx_mapper", op="identity", workers=workers),
            mod_stage("sgx_filter", op="delay_filter_u32", const=15,
                      workers=workers),
            mod_stage("reducer", op="custom", reduce_fn=fn,
                      reduce_init=init)]


def _port(mode, workers=1, **kw):
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    return Pipeline(_stages(Stage, fn, init, workers),
                    SecureStreamConfig(mode=mode), device="cpu", **kw)


def _jax(mode, workers=1, **kw):
    fn, init = j_resolve_reducer("carrier_delay_stats")
    return j_pipeline.Pipeline(_stages(j_pipeline.Stage, fn, init, workers),
                               JConfig(mode=mode), **kw)


def _numpy(records):
    recs = flight_records(records, seed=1)
    keep = recs[:, 1] > 15
    return (np.bincount(recs[keep, 0], minlength=20).astype(np.float64),
            np.bincount(recs[keep, 0], weights=recs[keep, 1]
                        .astype(np.float64), minlength=20))


def _np(out):
    return tuple(np.asarray(out[k]) for k in ("count", "sum"))


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _stage_accounting(rep):
    return {k: (rep[k]["chunks"], rep[k]["windows"], rep[k]["dispatches"],
                rep[k]["per_worker"], rep[k]["mac_failures"])
            for k in ("sgx_mapper", "sgx_filter", "reducer")}


def _revoking(p, records, at):
    def source():
        for i, c in enumerate(flight_chunks(records, CHUNK, seed=1)):
            if i == at:
                p.directory.revoke(p.worker_id("sgx_mapper", 1))
            yield c
    return source()


# ------------------------------------------------------- the oracle engine


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's oracle runs, each mode with two workers per stage
    -> {mode: (result, stage accounting, host syncs)}."""
    out = {}
    for mode in MODES:
        j_pipeline.reset_host_sync_count()
        p = _jax(mode, 2, window_chunks=1)
        res = p.run(jnp.asarray(c) for c in
                    flight_chunks(RECORDS, CHUNK, seed=1))
        out[mode] = (_np(res), _stage_accounting(p.report()),
                     j_pipeline.host_sync_count())
    return out


@pytest.mark.parametrize("mode", MODES)
def test_oracle_engine_equals_reference_window_engine_and_numpy(
        reference_runs, mode):
    want, accounting, syncs = reference_runs[mode]
    pipeline_mod.reset_host_sync_count()
    p = _port(mode, 2, window_chunks=1)
    got = _np(p.run(flight_chunks(RECORDS, CHUNK, seed=1)))
    assert _equal(got, want) and _equal(got, _numpy(RECORDS))
    # one window per chunk and stage, the same dispatches (3 per enclave
    # hop: two eager MACs and the enclave map; none for the scalar AEAD)
    # and one host sync per sealed chunk hop
    assert _stage_accounting(p.report()) == accounting
    assert pipeline_mod.host_sync_count() == syncs
    window = _np(_port(mode, 2).run(flight_chunks(RECORDS, CHUNK, seed=1)))
    assert _equal(got, window)


def test_oracle_engine_drops_a_tampered_chunk_and_streams_without_reduce():
    """A chunk whose ciphertext is altered between stages fails its MAC
    at the next hop: it is dropped, counted and audited; a reduce-less
    pipeline returns the last chunk and calls ``on_result`` per chunk."""
    p = Pipeline([Stage("a", op="scale_f32", const=2.0),
                  Stage("b", op="identity")],
                 SecureStreamConfig(mode="enclave"), window_chunks=1,
                 device="cpu")
    real = enclave.EnclaveExecutor.run_static

    def tamper(self, op, const, chunk):
        out = real(self, op, const, chunk)
        if op == "scale_f32" and chunk.counter == 1:  # chunk 1 leaving a
            out.blocks[0, 0] ^= 1
        return out

    seen = []
    xs = [torch.full((8, 16), float(i)) for i in range(3)]
    enclave.EnclaveExecutor.run_static = tamper
    try:
        last = p.run(xs, on_result=seen.append)
    finally:
        enclave.EnclaveExecutor.run_static = real
    rep = p.report()
    assert rep["b"]["mac_failures"] == 1 and rep["b"]["chunks"] == 2
    assert len(seen) == 2 and torch.equal(last, 2.0 * xs[2])
    assert torch.equal(seen[0], 2.0 * xs[0])
    assert p.directory.audit.summary()["mac_failure"] == 1
