"""The torch port's DelayedFlights job under ``rekey_every_n=3`` and a
mid-stream revocation against the JAX reference run with the same
cadence and revocation point, on the CPU: equal terminal reduces and the
same ordered sequence of rekey and revocation audit events."""
import jax.numpy as jnp
import numpy as np

from repro.core.pipeline import Pipeline as JPipeline
from repro_torch.core.pipeline import Pipeline
from repro_torch.data.synthetic import flight_chunks
from test_torch_pipeline import CHUNK, RECORDS, _jax, _port
from _torch_threads import one_torch_thread  # noqa: F401


def test_rekey_revocation_matches_reference_run():
    """The reference under the same rekey cadence and revocation point."""
    def run(p, revoke_id, chunks):
        def source():
            for i, c in enumerate(chunks):
                if i == 7:
                    p.directory.revoke(revoke_id)
                yield c
        return p.run(source(), rekey_every_n=3)

    j = _jax("encrypted", 2)
    jout = run(j, JPipeline.worker_id("sgx_mapper", 1),
               [jnp.asarray(c) for c in flight_chunks(RECORDS, CHUNK,
                                                      seed=1)])
    p = _port("encrypted", 2)
    out = run(p, Pipeline.worker_id("sgx_mapper", 1),
              list(flight_chunks(RECORDS, CHUNK, seed=1)))
    assert np.array_equal(out["count"].numpy(), np.asarray(jout["count"]))
    assert np.array_equal(out["sum"].numpy(), np.asarray(jout["sum"]))
    assert p.directory.audit.kind_sequence("rekey", "revocation") == \
        j.directory.audit.kind_sequence("rekey", "revocation")
