"""The 8-stage ``scale_f32`` job of the torch port against the JAX
reference on the CPU, and the port's per-hop accounting: dispatches per
window (2 per encrypted hop, 5 per enclave hop, 1 per ingress and per
egress window, as the reference pins them) and one host sync per
window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.configs.base import SecureStreamConfig as JConfig
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro_torch.attest.directory import KeyDirectory
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.dsl.reducers import resolve_reducer
from repro_torch.obs.metrics import dispatch_count, reset_dispatch_count

CONSTS = [1.0 + 0.0625 * i for i in range(8)]
N_CHUNKS, WORDS = 24, 64


def _src():
    return np.random.default_rng(7).standard_normal(
        (N_CHUNKS, WORDS)).astype(np.float32)


def _stages(cls, sum_fn):
    stages = [cls(f"s{i}", op="scale_f32", const=c,
                  workers=2 if i == 2 else 1) for i, c in enumerate(CONSTS)]
    stages.append(cls("sum", op="custom", reduce_fn=sum_fn, reduce_init=None))
    return stages


def _jax_sum(acc, chunk):
    return chunk if acc is None else acc + np.asarray(chunk)


@pytest.fixture(scope="module")
def numpy_chain():
    y = _src()
    for c in CONSTS:
        y = y * np.float32(c)
    return np.cumsum(y, axis=0, dtype=np.float32)[-1]


@pytest.mark.parametrize("mode", ["encrypted", "enclave"])
def test_stage8_sum_bit_equal_to_reference_and_numpy(mode, numpy_chain):
    x = _src()
    j = JPipeline(_stages(JStage, _jax_sum), JConfig(mode=mode),
                  directory=JKeyDirectory(seed=0, epoch_history=64))
    want = np.asarray(j.run(jnp.asarray(r) for r in x))
    fn, _ = resolve_reducer("sum")
    p = Pipeline(_stages(Stage, fn), SecureStreamConfig(mode=mode),
                 directory=KeyDirectory(seed=0, epoch_history=64),
                 device="cpu")
    got = p.run(torch.from_numpy(r) for r in x).numpy()
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert got.view(np.uint32).tobytes() == \
        numpy_chain.view(np.uint32).tobytes()


def _linear8(mode):
    stages = [Stage(f"s{i}", op="scale_f32", const=1.0 + 0.125 * i)
              for i in range(8)]
    return Pipeline(stages, SecureStreamConfig(mode=mode),
                    directory=KeyDirectory(seed=0), window_chunks=8,
                    device="cpu")


@pytest.mark.parametrize("mode,per_hop", [("encrypted", 2), ("enclave", 5),
                                          ("plain", 0)])
def test_dispatches_per_hop_and_one_host_sync_per_window(mode, per_hop):
    x = _src()[:16]                     # exactly two 8-chunk windows
    reset_dispatch_count()
    pipeline_mod.reset_host_sync_count()
    p = _linear8(mode)
    got = []
    p.run((torch.from_numpy(r) for r in x), on_result=got.append)
    assert len(got) == 16
    rep = p.report()
    for i in range(8):
        assert rep[f"s{i}"]["windows"] == 2
        assert rep[f"s{i}"]["dispatches_per_window"] == per_hop
    io = 1 if mode != "plain" else 0
    assert rep["dispatch"]["ingress"] == {"windows": 2,
                                          "dispatches": 2 * io}
    assert rep["dispatch"]["egress"] == {"windows": 2, "dispatches": 2 * io}
    assert dispatch_count() == rep["dispatch"]["total"] == \
        2 * (8 * per_hop + 2 * io)
    # one verdict sync per stage window + one per egress window
    assert pipeline_mod.host_sync_count() == 8 * 2 + 2


def test_tampered_row_is_dropped_and_audited():
    """A MAC failure on one row drops exactly that row at the next hop."""
    from repro_torch.core import enclave
    x = _src()[:8]
    p = _linear8("encrypted")
    orig = enclave.EnclaveExecutor.run_static_window
    calls = []

    def tamper(self, op, const, win, **kw):
        out, ok = orig(self, op, const, win, **kw)
        if not calls:
            out.words[3, 0] ^= 1        # corrupt row 3 after stage s0
        calls.append(1)
        return out, ok

    enclave.EnclaveExecutor.run_static_window = tamper
    try:
        got = []
        p.run((torch.from_numpy(r) for r in x), on_result=got.append)
    finally:
        enclave.EnclaveExecutor.run_static_window = orig
    assert len(got) == 7
    assert p.report()["s1"]["mac_failures"] == 1
    ev = p.directory.audit.events("mac_failure")
    assert len(ev) == 1 and ev[0].detail["stage"] == "s1" \
        and ev[0].detail["row"] == 3
