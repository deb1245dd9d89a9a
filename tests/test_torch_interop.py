"""State carried across packages: for one seed the reference and the
torch port derive the same edge keys and seal the same ingress
ciphertext, and a window sealed by either package opens in the other
through ``repro_torch.interop`` (the port imports nothing of ``repro``;
the test reads the reference's state into numpy itself)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SecureStreamConfig as JConfig
from repro.core import enclave as j_enclave
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro_torch import interop
from repro_torch.attest.directory import NoSessionError
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import enclave
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.data.synthetic import flight_chunks
from repro_torch.u32 import to_numpy
from _torch_threads import one_torch_thread  # noqa: F401

STAGES = [("sgx_mapper", "identity", 0.0), ("sgx_filter",
                                            "delay_filter_u32", 15.0)]


def _pipelines(mode="encrypted"):
    j = JPipeline([JStage(n, op=o, const=c) for n, o, c in STAGES],
                  JConfig(mode=mode), seed=3)
    p = Pipeline([Stage(n, op=o, const=c) for n, o, c in STAGES],
                 SecureStreamConfig(mode=mode), seed=3, device="cpu")
    return j, p


def _sessions(jdir):
    """The reference directory's live sessions, read into numpy."""
    return {e: {ep: np.asarray(k.key, np.uint32)
                for ep, k in jdir.session(e).keys.items()}
            for e in jdir.edges()}


def test_same_seed_same_edge_keys_and_ingress_ciphertext():
    j, p = _pipelines()
    for e in j.directory.edges():
        assert np.array_equal(p.directory.edge_key(e).key.view(np.uint32),
                              j.directory.edge_key(e).key)
    chunks = list(flight_chunks(4096, 256, seed=1))
    jwins = list(j._ingress_stream((jnp.asarray(c) for c in chunks),
                                   "encrypted", None, 8))
    wins = list(p._ingress_stream(iter(chunks), "encrypted", None, 8))
    assert len(wins) == len(jwins) == 2
    for w, jw in zip(wins, jwins):
        assert np.array_equal(to_numpy(w.words), np.asarray(jw.words))
        assert np.array_equal(to_numpy(w.tags), np.asarray(jw.tags))
        assert w.counters == jw.counters and w.epochs == jw.epochs
        assert w.meta == (tuple(jw.meta[0]), jw.meta[1], jw.meta[2])


def test_window_sealed_by_reference_opens_in_port():
    j, _ = _pipelines()
    x = np.random.default_rng(0).standard_normal((4, 33)).astype(np.float32)
    h = j.keys[1]
    base, epoch = h.reserve_window(4)
    jw = j_enclave.seal_tensors_window(h, range(base, base + 4),
                                       [jnp.asarray(r) for r in x],
                                       epoch=epoch)
    d = interop.directory_from_state(
        _sessions(j.directory), epoch=j.directory.epoch,
        counters={e: j.directory.session(e).chunks
                  for e in j.directory.edges()})
    win = interop.window_from_numpy(np.asarray(jw.words),
                                    np.asarray(jw.tags), jw.counters,
                                    jw.epochs, jw.meta, device="cpu")
    vals, ok = enclave.egress_window("encrypted", d.handle("edge1"), win)
    assert ok.tolist() == [True] * 4
    assert np.array_equal(vals.numpy(), x)
    assert d.session("edge1").chunks == j.directory.session("edge1").chunks
    # a tampered tag fails exactly its row
    win.tags[2, 0] ^= 1
    _, ok = enclave.egress_window("encrypted", d.handle("edge1"), win)
    assert ok.tolist() == [True, True, False, True]


def test_window_sealed_by_port_opens_in_reference():
    j, p = _pipelines()
    x = np.random.default_rng(1).integers(-128, 128, (3, 7)).astype(np.int8)
    h = p.keys[2]
    base, epoch = h.reserve_window(3)
    win = enclave.seal_tensors_window(h, range(base, base + 3),
                                      [torch.from_numpy(r) for r in x],
                                      epoch=epoch)
    state = interop.window_to_numpy(win)
    jw = j_enclave.SealedWindow(
        words=jnp.asarray(state["words"]), tags=jnp.asarray(state["tags"]),
        counters=state["counters"], epochs=state["epochs"],
        meta=state["meta"], n_words=state["words"].shape[1])
    vals, ok = j_enclave.egress_window("encrypted", j.keys[2], jw)
    assert np.asarray(ok).tolist() == [True] * 3
    assert np.array_equal(np.asarray(vals), x)


def _mixed_epoch_window(j, x):
    """A 4-row window on ``edge1`` sealed by the reference, rows 0-1 at
    epoch 0 and rows 2-3 at epoch 1 (a rekey flip mid-window)."""
    h = j.keys[1]
    parts = []
    for rows in (x[:2], x[2:]):
        base, epoch = h.reserve_window(len(rows))
        parts.append(j_enclave.seal_tensors_window(
            h, range(base, base + len(rows)), [jnp.asarray(r) for r in rows],
            epoch=epoch))
        if not j.directory.epoch:
            j.directory.advance_epoch()
    return j_enclave.SealedWindow(
        words=jnp.concatenate([w.words for w in parts]),
        tags=jnp.concatenate([w.tags for w in parts]),
        counters=sum((w.counters for w in parts), []),
        epochs=sum((w.epochs for w in parts), []),
        meta=parts[0].meta, n_words=parts[0].n_words)


@pytest.mark.parametrize("entry", ["static_encrypted", "static_enclave",
                                   "closure_encrypted"])
def test_reseal_as_matches_reference(entry):
    """A re-executed share (``reseal_as``) opens a mixed-epoch window
    under its ingress coordinates and re-seals it under a freshly
    reserved counter block: the port's output window equals the
    reference's bit for bit, it opens under the fresh coordinates, and
    its ciphertext differs from the steady-state re-seal (no
    (key, nonce, counter) triple is spent twice)."""
    kind, mode = entry.split("_")
    j, p = _pipelines(mode)
    p.directory.advance_epoch()                  # keep the port in step
    x = np.random.default_rng(2).standard_normal((4, 40)).astype(np.float32)
    jw = _mixed_epoch_window(j, x)
    state = {"words": np.asarray(jw.words), "tags": np.asarray(jw.tags),
             "counters": jw.counters, "epochs": jw.epochs, "meta": jw.meta}
    assert state["epochs"] == [0, 0, 1, 1]
    win = interop.window_from_numpy(**state, device="cpu")
    jbase, jep = j.keys[2].reserve_window(4)
    base, ep = p.keys[2].reserve_window(4)
    assert (base, ep) == (jbase, jep) == (0, 1)
    reseal = (range(base, base + 4), ep)
    jex = j_enclave.EnclaveExecutor(mode, j.keys[1], j.keys[2])
    ex = enclave.EnclaveExecutor(mode, p.keys[1], p.keys[2])
    if kind == "static":
        jrun = lambda w, **kw: jex.run_static_window(  # noqa: E731
            "scale_f32", 0.5, w, **kw)
        run = lambda w, **kw: ex.run_static_window(  # noqa: E731
            "scale_f32", 0.5, w, **kw)
    else:
        jrun = lambda w, **kw: jex.run_window(  # noqa: E731
            lambda t: t * 0.5, w, **kw)
        run = lambda w, **kw: ex.run_window(  # noqa: E731
            lambda t: t * 0.5, w, **kw)
    jout, jok = jrun(jw, reseal_as=reseal)
    out, ok = run(win, reseal_as=reseal)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 4
    assert np.array_equal(to_numpy(out.words), np.asarray(jout.words))
    assert np.array_equal(to_numpy(out.tags), np.asarray(jout.tags))
    assert out.counters == jout.counters == [0, 1, 2, 3]
    assert out.epochs == jout.epochs == [1] * 4
    vals, ok = enclave.egress_window(mode, p.keys[2], out)
    assert ok.tolist() == [True] * 4
    assert np.array_equal(vals.numpy(), x * np.float32(0.5))
    steady, _ = run(win)                          # ingress coordinates
    assert steady.counters == win.counters and steady.epochs == [0, 0, 1, 1]
    differ = (to_numpy(steady.words) != to_numpy(out.words)).all(axis=1)
    assert differ.all()
    with pytest.raises(ValueError, match="one fresh counter per row"):
        run(win, reseal_as=(range(3), ep))


def test_directory_from_state_ratchets_like_the_reference():
    j, _ = _pipelines()
    d = interop.directory_from_state(
        _sessions(j.directory), epoch=j.directory.epoch,
        transcripts={e: j.directory.session(e).transcript
                     for e in j.directory.edges()})
    j.directory.advance_epoch()
    d.advance_epoch()
    for e in j.directory.edges():
        assert np.array_equal(d.edge_key(e).key.view(np.uint32),
                              j.directory.edge_key(e).key)
    with pytest.raises(NoSessionError, match="epoch 5"):
        interop.directory_from_state(_sessions(j.directory), epoch=5)
