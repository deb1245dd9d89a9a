"""The enclave operator registry and the enclave map rows op of the torch
port against the JAX reference on the CPU, bit for bit.

The reference's CPU backend computes f32 ops with denormals flushed:
denormal inputs read as signed zero, and a product whose exact value is
below 2^-126 becomes signed zero even where it would round up to the
smallest normal.  The port spells those rules out on bit patterns, so
the cases below state the outcome for subnormal inputs and results."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.enclave_map import ops as j_em_ops
from repro.kernels.enclave_map.enclave_map import OPS as J_OPS
from repro.kernels.enclave_map.enclave_map import enclave_apply_rows
from repro_torch.kernels.enclave_map import ops as em_ops
from repro_torch.kernels.enclave_map.enclave_map import OPS, const_bits
from repro_torch.kernels.enclave_map.ref import enclave_apply_rows_ref
from repro_torch.obs.metrics import REGISTRY
from repro_torch.u32 import from_numpy, to_numpy

SPECIAL = np.array([
    0x7FC00000, 0x7F800001, 0xFFC00001, 0x7FA00000,   # NaNs (s and q)
    0x80000000, 0x00000000,                           # -0, +0
    0x00000001, 0x00400000, 0x80000001,               # subnormals
    0x3F800000, 0xBF800000, 0x1F800000, 0x1FFFFFFF,   # squares -> tiny
    0x20000000, 0x7F7FFFFF, 0xFF800000, 0x7F800000,   # 2^-63, max, -inf, inf
    0x00800000, 0x80800000, 0x00800001,               # smallest normals
    0x80000010, 0xFFFFFFFF, 16, 15, 5,                # >= 2^31, delays
], dtype=np.uint32)
CONSTS = [0.0, 0.1, -2.5, 2.0 ** 40, float(np.float32(1 - 2 ** -24)),
          float("nan"), -float("nan"), float("inf"), 1e-40, 15.7, -1.5]


def _words(rows=64, seed=0):
    rng = np.random.default_rng(seed)
    w = np.concatenate([
        SPECIAL,
        rng.integers(0, 2 ** 32, rows * 16 - len(SPECIAL), dtype=np.uint32),
        rng.standard_normal(rows * 16).astype(np.float32).view(np.uint32),
        (rng.standard_normal(rows * 16) * 1e-38).astype(np.float32)
        .view(np.uint32)])
    return w.reshape(-1, 16)


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("op", list(OPS))
def test_every_op_bit_equal_to_reference_on_adversarial_words(op):
    w = _words()
    for c in CONSTS:
        if op == "delay_filter_u32" and not (np.isfinite(c) and
                                             abs(c) < 2 ** 31):
            continue
        want = np.asarray(J_OPS[op](jnp.asarray(w), c))
        got = to_numpy(OPS[op](from_numpy(w, "cpu"), c))
        assert np.array_equal(got, want), (op, c)


def _one(op, c, words):
    w = np.zeros((1, 16), np.uint32)
    w[0, :len(words)] = words
    got = to_numpy(OPS[op](from_numpy(w, "cpu"), c))[0, :len(words)]
    want = np.asarray(J_OPS[op](jnp.asarray(w), c))[0, :len(words)]
    assert np.array_equal(got, want)
    return [int(v) for v in got]


def test_subnormal_and_nan_outcomes_stated():
    # a product that rounds up to 2^-126 but is below it exactly: flushed
    assert _one("scale_f32", float(np.float32(1 - 2 ** -24)),
                [0x00800000, 0x80800000]) == [0, 0x80000000]
    # squares below 2^-126 flush; exactly 2^-126 survives
    assert _one("square_f32", 0.0, [0x1F800000, 0x1FFFFFFF, 0x20000000]) \
        == [0, 0, 0x00800000]
    # denormal inputs read as zero: x * 2^40 stays (signed) zero
    assert _one("scale_f32", 2.0 ** 40, [0x00400000, 0x80400000]) \
        == [0, 0x80000000]
    # relu: NaN bits pass untouched, -0 and positive denormals become +0
    assert _one("relu_f32", 0.0, [0x7F800001, 0x80000000, 0x00000001,
                                  0x3F800000]) == [0x7F800001, 0, 0,
                                                   0x3F800000]
    # threshold_mask selects x's own bits (a denormal kept as it is)
    assert _one("threshold_mask", -0.5, [0x00000001, 0x7FC00000]) \
        == [0x00000001, 0]
    # NaN propagation: the constant's NaN first, then x's, quieted;
    # 0 x inf is the default NaN
    assert _one("scale_f32", float("nan"), [0x7F800001]) == [0x7FC00000]
    assert _one("scale_f32", 0.5, [0x7F800001]) == [0x7FC00001]
    assert _one("scale_f32", 0.0, [0x7F800000]) == [0xFFC00000]
    # delay word compared as signed int32 against int(c)
    assert _one("delay_filter_u32", 15.7, [5, 16]) == [5, 16]
    assert _one("delay_filter_u32", 15.0, [5, 0x80000010]) == [0, 0]


def test_const_rounds_like_a_weak_typed_jax_scalar():
    assert const_bits(0.1) == 0x3DCCCCCD
    assert const_bits(-float("nan")) & 0xFFFFFFFF == 0xFFC00000


@pytest.mark.parametrize("op,const", [("identity", 0.0), ("scale_f32", 2.5),
                                      ("threshold_mask", 0.25),
                                      ("delay_filter_u32", 15.0)])
def test_enclave_rows_plain_matches_reference_interpret(op, const):
    """Per-row keys (a mixed-epoch window) and separate outbound
    coordinates (the re-execution path)."""
    R = 64
    kin, kout = _u32((R, 8), 1), _u32((R, 8), 2)
    nonces, counters = _u32((R, 3), 3), _u32(R, 4)
    nonces_out, counters_out = _u32((R, 3), 5), _u32(R, 6)
    rows = _u32((R, 16), 7)
    want = np.asarray(enclave_apply_rows(
        *map(jnp.asarray, (kin, kout, nonces, counters, rows)), op=op,
        const=const, block_rows=R, interpret=True,
        nonces_out=jnp.asarray(nonces_out),
        counters_out=jnp.asarray(counters_out)))
    t = lambda a: from_numpy(a, "cpu")      # noqa: E731
    got = enclave_apply_rows_ref(t(kin), t(kout), t(nonces), t(counters),
                                 t(rows), op=op, const=const,
                                 nonces_out=t(nonces_out),
                                 counters_out=t(counters_out))
    assert np.array_equal(to_numpy(got), want)


def test_enclave_map_rows_ragged_and_shared_keys_match_reference_op():
    """R=300 is not a multiple of the reference's 256-row tile: the
    reference op pads and slices, the port's wrapper masks the tail.
    Each call counts one dispatch, as the reference's does."""
    R = 300
    kin, kout = _u32(8, 8), _u32(8, 9)
    nonces, counters, rows = _u32((R, 3), 10), _u32(R, 11), _u32((R, 16), 12)
    want = np.asarray(j_em_ops.enclave_map_rows(
        *map(jnp.asarray, (kin, kout, nonces, counters, rows)),
        op="relu_f32"))
    REGISTRY.reset("device.dispatches")
    t = lambda a: from_numpy(a, "cpu")      # noqa: E731
    got = em_ops.enclave_map_rows(t(kin), t(kout), t(nonces), t(counters),
                                  t(rows), op="relu_f32")
    assert np.array_equal(to_numpy(got), want)
    assert REGISTRY.snapshot()["device.dispatches.enclave_map"] == 1
    with pytest.raises(ValueError, match="unknown enclave op"):
        em_ops.enclave_map_rows(t(kin), t(kout), t(nonces), t(counters),
                                t(rows), op="gelu")


def test_wrappers_refuse_a_device_they_cannot_serve():
    rows = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")  # noqa
    with pytest.raises(ValueError, match="CUDA"):
        em_ops.enclave_map_rows(z(8), z(8), z(4, 3), z(4), rows,
                                op="identity")
