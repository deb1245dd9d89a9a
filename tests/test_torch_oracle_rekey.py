"""The per-chunk oracle engine of the torch port under rekey_every_n=3
with a mid-stream revocation, against the JAX reference's oracle on the
CPU, bit for bit: result, per-stage accounting, host syncs and audit
summary.  Its own file (and xdist worker) because the reference's oracle
is slow on the CPU; the helpers are ``tests/test_torch_oracle.py``'s."""
import jax.numpy as jnp
import pytest

from repro.core import pipeline as j_pipeline
from repro_torch.core import pipeline as pipeline_mod
from test_torch_oracle import (_equal, _jax, _np, _numpy, _port,
                               _revoking, _stage_accounting)

RECORDS = 256                   # 4 chunks: rekeyed once, one revocation


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's oracle runs in both sealed modes, two workers per
    stage -> {mode: (result, stage accounting, host syncs, audit)}."""
    out = {}
    for mode in ("encrypted", "enclave"):
        p = _jax(mode, 2, window_chunks=1)
        j_pipeline.reset_host_sync_count()
        res = p.run((jnp.asarray(c) for c in _revoking(p, RECORDS, 2)),
                    rekey_every_n=3)
        out[mode] = (_np(res), _stage_accounting(p.report()),
                     j_pipeline.host_sync_count(),
                     p.directory.audit.summary())
    return out


@pytest.mark.parametrize("mode", ["encrypted", "enclave"])
def test_oracle_engine_rekey_and_revocation_equal_reference(reference_runs,
                                                            mode):
    want, accounting, syncs, audit = reference_runs[mode]
    p = _port(mode, 2, window_chunks=1)
    pipeline_mod.reset_host_sync_count()
    got = _np(p.run(_revoking(p, RECORDS, 2), rekey_every_n=3))
    assert _equal(got, want) and _equal(got, _numpy(RECORDS))
    assert _stage_accounting(p.report()) == accounting
    assert pipeline_mod.host_sync_count() == syncs
    assert p.directory.audit.summary() == audit
    assert audit["rekey"] >= 1 and audit["revocation"] == 1
