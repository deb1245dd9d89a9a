"""The torch port's engines against the JAX reference's on the CPU where
a window factor of 1 (asked for, or forced by a tight rekey cadence)
runs the per-chunk oracle engine in both packages, on a short stream
(the reference's oracle is slow on the CPU: its own file).  Helpers are
``tests/test_torch_pipeline.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.data.synthetic import flight_chunks
from test_torch_pipeline import (CHUNK, RECORDS, SHORT, _as_np,
                                 _assert_equal, _jax, _port, _short)
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    """The reference's encrypted-mode terminal reduce (one worker)."""
    res = _jax("encrypted", 1).run(jnp.asarray(c) for c in
                                   flight_chunks(RECORDS, CHUNK, seed=1))
    return {"encrypted": (np.asarray(res["count"]), np.asarray(res["sum"]))}


@pytest.fixture(scope="module")
def oracle_reference():
    """The reference's per-chunk oracle runs on the short stream, in
    encrypted mode: asked for (one worker, ``window_chunks=1``), and
    forced (two workers, ``rekey_every_n=3`` against an epoch history of
    3, which clamps the window to 1).  -> {case: (count, sum)}."""
    asked = _jax("encrypted", 1).run(
        (jnp.asarray(c) for c in _short()), window_chunks=1)
    forced = _jax("encrypted", 2,
                  directory=JKeyDirectory(seed=0, epoch_history=3)).run(
        (jnp.asarray(c) for c in _short()), rekey_every_n=3)
    return {name: (np.asarray(r["count"]), np.asarray(r["sum"]))
            for name, r in (("asked", asked), ("forced", forced))}


@pytest.mark.parametrize("wc", [2, 4])
def test_run_window_chunks_override_keeps_result(reference,
                                                 oracle_reference, wc):
    """``run(window_chunks=)`` re-windows one run: RECORDS / CHUNK = 16
    chunks in windows of ``wc``, the same terminal reduce; a factor of 1
    runs the per-chunk oracle engine, equal to the reference's."""
    p = _port("encrypted", 1)
    got = _as_np(p.run(flight_chunks(RECORDS, CHUNK, seed=1),
                       window_chunks=wc))
    for g, j in zip(got, reference["encrypted"]):
        assert np.array_equal(g, j)
    rep = p.report()
    assert rep["sgx_mapper"]["windows"] == RECORDS // CHUNK // wc
    assert p.window_chunks == 8                 # the pipeline's own factor
    # a fresh pipeline (the reducer's state carries over between runs of
    # one pipeline, as in the reference) with the factor overridden to 1
    p = _port("encrypted", 1, window_chunks=wc)
    _assert_equal(_as_np(p.run(_short(), window_chunks=1)),
                  oracle_reference["asked"])
    assert p.window_chunks == wc
    # the oracle engine counts one window per chunk
    assert p.report()["sgx_mapper"]["windows"] == SHORT // CHUNK


def test_unported_paths_raise_not_implemented(oracle_reference):
    """Nothing on these paths is unported any more: a window factor of 1,
    asked for or forced by a tight rekey cadence, runs the per-chunk
    oracle engine and equals the reference's; fault tolerance is
    accepted by the window engine and, as in the reference, refused with
    a ``ValueError`` (not ``NotImplementedError``) on the oracle."""
    from repro_torch.ft import ChaosPlan, RetryPolicy
    _assert_equal(_as_np(_port("encrypted", 1, window_chunks=1).run(
        _short())), oracle_reference["asked"])
    with pytest.raises(ValueError, match="window_chunks >= 2"):
        _port("encrypted", 1).run(_short(), window_chunks=1,
                                  retry=RetryPolicy())
    assert _port("encrypted", 1, chaos=ChaosPlan()).chaos.faults == []
    # a rekey cadence that clamps the window to 1 runs the oracle engine
    tight = _port("encrypted", 2,
                  directory=pipeline_mod.KeyDirectory(seed=0,
                                                      epoch_history=3))
    _assert_equal(_as_np(tight.run(_short(), rekey_every_n=3)),
                  oracle_reference["forced"])
    assert tight.report()["sgx_mapper"]["windows"] == SHORT // CHUNK
    assert tight.directory.audit.summary()["rekey"] == 1
