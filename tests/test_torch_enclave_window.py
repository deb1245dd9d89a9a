"""The window engine's enclave hop of the torch port against the JAX
reference on the CPU, bit for bit, at ragged word counts.

The port runs the hop as one call over the window's (B, n) words
(``enclave_map_window``); the reference pads the words to whole blocks,
expands per-row nonces, counters and keys and runs its per-row Pallas
kernel (in interpret mode here).  A ragged tail decrypts as zero
ciphertext in both, so the op sees keystream words there: the delay
filter at n = 1 decides on such a word."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import SecureStreamConfig as JConfig
from repro.core import enclave as j_enclave
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro.kernels.enclave_map.enclave_map import enclave_apply_rows
from repro_torch import interop
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import enclave
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.kernels.enclave_map import ops as em_ops
from repro_torch.kernels.enclave_map.enclave_map import OPS
from repro_torch.kernels.enclave_map.ref import enclave_map_window_ref
from repro_torch.obs.metrics import REGISTRY
from repro_torch.u32 import from_numpy, to_numpy
from _torch_threads import one_torch_thread  # noqa: F401

CONST = {"identity": 0.0, "scale_f32": -2.5, "relu_f32": 0.0,
         "square_f32": 0.0, "threshold_mask": 0.25,
         "delay_filter_u32": 15.0}


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                                dtype=np.uint32)


def _reference_hop(kin, kout, nonces, words, op, nonces_out):
    """The reference's composition: padded rows, per-row coordinates
    (its kernel takes per-row keys only), its per-row kernel, the slice
    back to (B, n)."""
    B, n = words.shape
    nb = -(-n // 16)
    rows = np.zeros((B, nb * 16), np.uint32)
    rows[:, :n] = words
    out = enclave_apply_rows(
        *(jnp.asarray(np.repeat(a, nb, axis=0))
          for a in (kin, kout, nonces)),
        jnp.asarray(np.tile(np.arange(1, nb + 1, dtype=np.uint32), B)),
        jnp.asarray(rows.reshape(-1, 16)), op=op, const=CONST[op],
        block_rows=B * nb, interpret=True,
        nonces_out=jnp.asarray(np.repeat(nonces_out, nb, axis=0)))
    return np.asarray(out).reshape(B, -1)[:, :n]


@pytest.mark.parametrize("n", [1, 17, 37])
@pytest.mark.parametrize("op", list(OPS))
def test_window_plain_version_equals_reference_composition(op, n):
    """Items 0-1: shared keys, a single-epoch window; items 2-3: per-item
    keys and fresh outbound nonces (a mixed-epoch window re-sealed by a
    retry).  One reference call covers both."""
    words = _u32((4, n), 1)
    if n > 1:
        words[:, 1] = [7, 40, 15, 16]            # delays about the filter
    kin, kout = _u32((3, 8), 2), _u32((3, 8), 3)
    nonces, nout = _u32((4, 3), 4), _u32((2, 3), 5)
    want = _reference_hop(kin[[0, 0, 1, 2]], kout[[0, 0, 1, 2]], nonces,
                          words, op, np.concatenate([nonces[:2], nout]))
    t = lambda a: from_numpy(a, "cpu")      # noqa: E731
    got = enclave_map_window_ref(t(kin[0]), t(kout[0]), t(nonces[:2]),
                                 t(words[:2]), op=op, const=CONST[op])
    assert got.shape == (2, n) and got.is_contiguous()
    assert np.array_equal(to_numpy(got), want[:2])
    got = enclave_map_window_ref(t(kin[1:]), t(kout[1:]), t(nonces[2:]),
                                 t(words[2:]), op=op, const=CONST[op],
                                 nonces_out=t(nout))
    assert np.array_equal(to_numpy(got), want[2:])


def test_window_wrapper_counts_one_dispatch_and_checks_operands():
    B, n = 3, 17
    t = lambda a: from_numpy(a, "cpu")      # noqa: E731
    args = (t(_u32(8, 1)), t(_u32((B, 8), 2)), t(_u32((B, 3), 3)),
            t(_u32((B, n), 4)))
    REGISTRY.reset("device.dispatches")
    got = em_ops.enclave_map_window(*args, op="relu_f32")
    assert REGISTRY.snapshot()["device.dispatches.enclave_map"] == 1
    assert REGISTRY.snapshot()["device.dispatches"] == 1
    assert np.array_equal(to_numpy(got), to_numpy(enclave_map_window_ref(
        *args, op="relu_f32")))
    with pytest.raises(ValueError, match="unknown enclave op"):
        em_ops.enclave_map_window(*args, op="gelu")
    with pytest.raises(ValueError, match="nonces_out"):
        em_ops.enclave_map_window(*args, op="identity",
                                  nonces_out=t(_u32((B + 1, 3), 5)))
    with pytest.raises(ValueError, match="keys_in"):
        em_ops.enclave_map_window(t(_u32((B + 1, 8), 6)), *args[1:],
                                  op="identity")


def _pipelines():
    stages = [("sgx_mapper", "identity", 0.0),
              ("sgx_filter", "delay_filter_u32", 15.0)]
    j = JPipeline([JStage(n, op=o, const=c) for n, o, c in stages],
                  JConfig(mode="enclave"), seed=5)
    p = Pipeline([Stage(n, op=o, const=c) for n, o, c in stages],
                 SecureStreamConfig(mode="enclave"), seed=5, device="cpu")
    return j, p


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


@pytest.mark.parametrize("n,op", [(1, "delay_filter_u32"),
                                  (17, "scale_f32"),
                                  (37, "delay_filter_u32")])
def test_run_static_window_enclave_equals_reference(n, op):
    """The port's enclave-mode hop on a mixed-epoch window of ragged
    records, steady state and re-sealed under a fresh counter block
    (``reseal_as``): words, tags and verdicts equal the reference's."""
    j, p = _pipelines()
    p.directory.advance_epoch()                  # keep the port in step
    x = _u32((4, n), 8)
    if n > 1:
        x[:, 1] = [3, 16, 90, 15]                # delays about the filter
    jw = _mixed_epoch_window(j, x)
    assert jw.epochs == [0, 0, 1, 1]
    win = interop.window_from_numpy(
        np.asarray(jw.words), np.asarray(jw.tags), jw.counters, jw.epochs,
        jw.meta, device="cpu")
    jex = j_enclave.EnclaveExecutor("enclave", j.keys[1], j.keys[2])
    ex = enclave.EnclaveExecutor("enclave", p.keys[1], p.keys[2])
    c = CONST[op]
    jout, jok = jex.run_static_window(op, c, jw)
    out, ok = ex.run_static_window(op, c, win)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 4
    assert np.array_equal(to_numpy(out.words), np.asarray(jout.words))
    assert np.array_equal(to_numpy(out.tags), np.asarray(jout.tags))
    jbase, jep = j.keys[2].reserve_window(4)
    base, ep = p.keys[2].reserve_window(4)
    assert (base, ep) == (jbase, jep)
    reseal = (range(base, base + 4), ep)
    jout, _ = jex.run_static_window(op, c, jw, reseal_as=reseal)
    out, ok = ex.run_static_window(op, c, win, reseal_as=reseal)
    assert ok.tolist() == [True] * 4
    assert np.array_equal(to_numpy(out.words), np.asarray(jout.words))
    assert np.array_equal(to_numpy(out.tags), np.asarray(jout.tags))
    assert out.counters == jout.counters and out.epochs == [ep] * 4
