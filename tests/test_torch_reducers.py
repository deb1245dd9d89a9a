"""The port's ``carrier_delay_stats`` reducer against the JAX reference's
on the CPU, on records whose carrier word lies outside the carrier table.

The reference folds ``carrier[delay > 0]`` only, so an undelayed record
counts nowhere whatever its carrier word, and a delayed record whose
carrier is >= ``num_carriers`` makes its fold raise (the histogram
outgrows the accumulator).  The port folds on the device without a host
sync and raises once, when the run's terminal state is finished."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SecureStreamConfig as JConfig
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro.dsl import stream as j_stream
from repro.dsl.reducers import resolve_reducer as j_resolve_reducer
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.dsl import stream
from repro_torch.dsl.reducers import resolve_reducer
from repro_torch.u32 import from_numpy

U32_MAX = 2 ** 32 - 1


def _records(carriers, delays, rows=None, seed=0):
    """(rows, 16) uint32 flight records: word 0 the carrier, word 1 the
    delay, the rest random."""
    rows = len(carriers) if rows is None else rows
    rec = np.random.default_rng(seed).integers(0, 2 ** 32, (rows, 16),
                                               dtype=np.uint32)
    rec[:, 0] = carriers
    rec[:, 1] = delays
    return rec


def _random_chunk(seed, rows=64):
    """Undelayed rows carry any carrier word, delayed rows one of the
    20 carriers."""
    rng = np.random.default_rng(seed)
    delays = np.where(rng.random(rows) < 0.5, 0,
                      rng.integers(1, 2 ** 32, rows, dtype=np.uint32))
    carriers = np.where(delays == 0,
                        rng.integers(0, 2 ** 32, rows, dtype=np.uint32),
                        rng.integers(0, 20, rows))
    return _records(carriers, delays, seed=seed)


def _fold_port(chunks):
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    acc = init
    for c in chunks:
        acc = fn(acc, from_numpy(c, "cpu"))
    return fn.finish(acc)


def _fold_reference(chunks):
    fn, acc = j_resolve_reducer("carrier_delay_stats")
    for c in chunks:
        acc = fn(acc, jnp.asarray(c))
    return acc


def _equal(port, ref):
    assert sorted(port) == sorted(ref) == ["count", "sum"]
    for k in ("count", "sum"):
        got = port[k].numpy()
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, np.asarray(ref[k]))


CASES = {
    # an undelayed record with carrier 25 counts nowhere
    "roadmap": [_records([1, 2, 25, 3], [10, 5, 0, 7])],
    # an undelayed carrier word of 2^32 - 1 (no 2^32-bin histogram)
    "u32_max": [_records([U32_MAX, 4, 4], [0, 9, U32_MAX])],
    "random": [_random_chunk(s) for s in range(3)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_fold_equals_reference_on_out_of_range_undelayed(case):
    _equal(_fold_port(CASES[case]), _fold_reference(CASES[case]))


def test_delayed_out_of_range_carrier_raises_in_both():
    chunks = [_records([1, 25], [10, 3])]
    with pytest.raises(ValueError):
        _fold_reference(chunks)
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    acc = fn(init, from_numpy(chunks[0], "cpu"))      # the fold does not
    with pytest.raises(ValueError, match="num_carriers=20"):
        fn.finish(acc)


def test_fold_leaves_init_untouched():
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    before = {k: v.clone() for k, v in init.items()}
    out = fn.finish(fn(fn(init, from_numpy(_random_chunk(5), "cpu")),
                       from_numpy(_random_chunk(6), "cpu")))
    assert sorted(init) == ["count", "sum"]
    for k in before:
        assert torch.equal(init[k], before[k])
        assert out[k] is not init[k]
    assert float(out["count"].sum()) > 0


def _pipelines(window):
    fn, init = resolve_reducer("carrier_delay_stats", device="cpu")
    jfn, jinit = j_resolve_reducer("carrier_delay_stats")
    port = Pipeline([Stage("m", op="identity"),
                     Stage("r", op="custom", reduce_fn=fn,
                           reduce_init=init)],
                    SecureStreamConfig(mode="plain"), window_chunks=window,
                    device="cpu")
    ref = JPipeline([JStage("m", op="identity"),
                     JStage("r", op="custom", reduce_fn=jfn,
                            reduce_init=jinit)],
                    JConfig(mode="plain"), window_chunks=window)
    return port, ref


# window factor 1 is the per-chunk oracle engine, 2 the window engine
@pytest.mark.parametrize("window", [1, 2])
def test_pipeline_run_counts_out_of_range_undelayed_like_reference(window):
    chunks = [_random_chunk(s) for s in range(4)]
    port, ref = _pipelines(window)
    _equal(port.run(iter(chunks)), ref.run(iter(chunks)))


@pytest.mark.parametrize("window", [1, 2])
def test_pipeline_run_raises_on_delayed_out_of_range_like_reference(window):
    chunks = [_random_chunk(s) for s in range(3)]
    chunks[1][7, :2] = [21, 30]               # a delayed record, carrier 21
    port, ref = _pipelines(window)
    with pytest.raises(ValueError):
        ref.run(iter(chunks))
    with pytest.raises(ValueError, match="1 delayed records"):
        port.run(iter(chunks))


def test_dsl_and_observable_oracle_finish_like_the_engine():
    chunks = CASES["roadmap"] * 2
    want = _fold_reference(chunks)
    sb = stream().reduce("carrier_delay_stats", name="r").device("cpu")
    _equal(sb.run(chunks, mode="plain"), want)
    _equal(sb.as_observable(chunks).subscribe(), want)
    _equal(_fold_port(chunks),
           j_stream().reduce("carrier_delay_stats", name="r").run(
               chunks, mode="plain"))
    bad = [_records([1, 25], [10, 3])]
    with pytest.raises(ValueError):
        sb.as_observable(bad).subscribe()
