"""The scalar chunk paths of the torch port's enclave executor (seal,
open, run, run_static, ingress, egress), its routers and its Observable
layer against the JAX reference on the CPU, bit for
bit.  These are what the per-chunk oracle engine runs on
(``tests/test_torch_oracle.py``).  Keys come from ``KeyDirectory(seed=)``
in both packages, which derive the same session keys."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.core import enclave as j_enclave
from repro.core import observable as j_obs
from repro.core import router as j_router
from repro_torch.attest.directory import KeyDirectory
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import enclave, observable, router
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.u32 import from_numpy, to_numpy
from _torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------- scalar paths of the executor


def _directories(seed=3):
    """Both packages' directories with one edge pair a -> s -> b."""
    from repro.attest.measure import IO_ENDPOINT as J_IO
    from repro_torch.attest.measure import IO_ENDPOINT
    out = []
    for d, io in ((KeyDirectory(seed=seed), IO_ENDPOINT),
                  (JKeyDirectory(seed=seed), J_IO)):
        for name in ("a", "s", "b"):
            d.enroll(name, io, allow=True)
        d.establish("in", "a", "s", stage_id=1)
        d.establish("out", "s", "b", stage_id=2)
        out.append(d)
    return out


def _same_chunk(c, jc):
    assert np.array_equal(to_numpy(c.blocks), np.asarray(jc.blocks))
    assert (c.counter, c.epoch, c.n_words) == (jc.counter, jc.epoch,
                                               jc.n_words)
    if jc.tag is None:
        assert c.tag is None
    else:
        assert np.array_equal(to_numpy(c.tag), np.asarray(jc.tag))


def test_scalar_chunk_paths_equal_reference_across_an_epoch_flip():
    d, jd = _directories()
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    hin, jhin = d.handle("in"), jd.handle("in")
    old = enclave.seal_tensor(hin, 0, torch.as_tensor(x))
    j_old = j_enclave.seal_tensor(jhin, 0, jnp.asarray(x))
    _same_chunk(old, j_old)
    assert d.advance_epoch() == jd.advance_epoch() == 1
    new = enclave.seal_tensor(hin, 0, torch.as_tensor(x))
    _same_chunk(new, j_enclave.seal_tensor(jhin, 0, jnp.asarray(x)))
    assert new.epoch == 1 and not torch.equal(new.blocks, old.blocks)
    # the old-epoch chunk still opens under its own epoch after the flip
    y, ok = enclave.open_tensor(hin, old)
    assert bool(ok) and np.array_equal(y.numpy(), x)
    hout, jhout = d.handle("out"), jd.handle("out")
    ex = enclave.EnclaveExecutor("encrypted", hin, hout)
    j_ex = j_enclave.EnclaveExecutor("encrypted", jhin, jhout)
    _same_chunk(ex.run(lambda t: t * 3.0, old),
                j_ex.run(lambda t: t * 3.0, j_old))
    for op, c in (("scale_f32", -1.5), ("relu_f32", 0.0)):
        ex = enclave.EnclaveExecutor("enclave", hin, hout)
        j_ex = j_enclave.EnclaveExecutor("enclave", jhin, jhout)
        _same_chunk(ex.run_static(op, c, old),
                    j_ex.run_static(op, c, j_old))
    # a tampered tag is dropped and counted, as in the reference
    bad = enclave.SealedChunk(old.blocks, old.tag ^ 1, old.counter,
                              old.meta, old.n_words, old.epoch)
    for mode in ("encrypted", "enclave"):
        ex = enclave.EnclaveExecutor(mode, hin, hout)
        assert ex.run_static("identity", 0.0, bad) is None
        assert ex.errors == 1
    with pytest.raises(ValueError, match="no-dynamic-linking"):
        enclave.EnclaveExecutor("enclave", hin, hout).run(lambda t: t, old)


def test_plain_chunks_windows_and_egress_round_trip():
    """Chunks in plain mode, and the window that the same tensors make
    when sealed as one, open back to their cleartext."""
    x = torch.arange(40, dtype=torch.int32).reshape(4, 10)
    c = enclave.ingress("plain", None, 7, x)
    jc = j_enclave.ingress("plain", None, 7, jnp.asarray(x.numpy()))
    _same_chunk(c, jc)
    y, ok = enclave.egress("plain", None, c)
    assert bool(ok) and torch.equal(y, x)
    assert np.array_equal(
        enclave._apply_static_f32("delay_filter_u32", 15.0, x).numpy(),
        np.asarray(j_enclave._apply_static_f32(
            "delay_filter_u32", 15.0, jnp.asarray(x.numpy()))))
    d, _ = _directories()
    h = d.handle("in")
    chunks = [enclave.seal_tensor(h, i, x + i) for i in range(3)]
    win = enclave.seal_tensors_window(h, [0, 1, 2], [x + i for i in range(3)])
    assert win.counters == [0, 1, 2] and tuple(win.words.shape) == (3, 40)
    for b, c in enumerate(chunks):
        assert torch.equal(win.words[b], c.blocks.reshape(-1)[:40])
        assert torch.equal(win.tags[b], c.tag)
    pt, ok = enclave.egress_window("encrypted", h, win)
    assert bool(ok.all()) and torch.equal(pt[2], x + 2)


# ------------------------------------------------------------------ routers


def test_round_robin_and_fair_queue_equal_reference():
    items = list(range(11))
    for w in (1, 3, 4):
        assert router.round_robin(items, w) == j_router.round_robin(items, w)
    streams = [[1, 2, 3], [], [4], [5, 6]]
    assert list(router.fair_queue(streams)) == \
        list(j_router.fair_queue(streams))


@pytest.mark.parametrize("workers", [1, 3, 4])
def test_fair_queue_restores_round_robin_order(workers):
    """Dispatch round-robin, merge by fair queue: the stream's order comes
    back, as the per-chunk engine relies on; also for a ragged stream."""
    for n in (12, 11):
        items = list(range(n))
        queues = router.round_robin(items, workers)
        assert list(router.fair_queue(queues)) == \
            list(j_router.fair_queue(j_router.round_robin(items, workers))) \
            == items


# ---------------------------------------------------------------- observable


def test_observable_equals_reference():
    rng = np.random.default_rng(2)
    chunks = [rng.integers(0, 100, (6, 2)).astype(np.int32)
              for _ in range(5)]

    def build(obs, src, cat):
        return (obs.Observable.from_chunks(src)
                .map(lambda c: c * 2)
                .filter(lambda c: c[:, 0] > 50)
                .window(2)
                .reduce(lambda acc, c, m: acc + [
                    (cat(c["data"]) if isinstance(c, dict) else c,
                     m)], init=[]))

    got = build(observable, [torch.as_tensor(c) for c in chunks],
                lambda x: x).subscribe()
    want = build(j_obs, [jnp.asarray(c) for c in chunks],
                 lambda x: x).subscribe()
    assert len(got) == len(want)
    for (g, gm), (w, wm) in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(gm.numpy(), np.asarray(wm))
    # key_by, ragged from_array, describe and the error path
    x = np.arange(14, dtype=np.int32).reshape(7, 2)
    seen, jseen = [], []
    observable.Observable.from_array(torch.as_tensor(x), 3).key_by(
        lambda c: c[:, 0] % 3, 3).subscribe(on_next=seen.append)
    j_obs.Observable.from_array(jnp.asarray(x), 3).key_by(
        lambda c: c[:, 0] % 3, 3).subscribe(on_next=jseen.append)
    assert [s["keys"].tolist() for s in seen] == \
        [np.asarray(s["keys"]).tolist() for s in jseen]
    ops = observable.Observable.from_chunks([]).map(abs).filter(
        lambda c: c > 0)
    j_ops = j_obs.Observable.from_chunks([]).map(abs).filter(
        lambda c: c > 0)
    assert ops.describe() == j_ops.describe() == "map(abs) -> filter"
    errors = []
    observable.Observable.from_chunks([torch.zeros(1)]).map(
        lambda c: 1 / 0).subscribe(on_error=errors.append)
    assert isinstance(errors[0], ZeroDivisionError)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline([Stage("m", op="identity")],
                 SecureStreamConfig(mode="plain"), window_chunks=1)
    chunk = from_numpy(np.zeros((4, 16), np.uint32), "cpu")
    assert enclave.unplain_chunk(enclave.plain_chunk(0, chunk)).device \
        .type == "cpu"
