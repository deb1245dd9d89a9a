"""The AEAD's one-launch cipher pass against the JAX reference, on the CPU.

``kernels.chacha20.ops.cipher_pass`` / ``cipher_pass_message`` run their
plain versions here (CPU tensors); the reference is the JAX package's
batched ``_cipher_pass`` and ``_mac_keys_rows``, its single-message
``_fused_stream`` and ``derive_mac_keys``, and its public seal/open
functions.  Inputs come from a seeded numpy generator; every comparison
is bit equality.  The reference functions are jitted once per shape.
The public seal/open functions: ``tests/test_torch_cipher_pass_aead.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import aead as j_aead
from repro_torch.crypto import aead
from repro_torch.kernels.chacha20 import ops as chacha_ops
from repro_torch.kernels.chacha20.ref import cipher_pass_ref
from repro_torch.obs.metrics import REGISTRY
from repro_torch.u32 import from_numpy, to_numpy
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
BATCHES = [1, 3, 8]
#: ragged and unaligned word counts, n = 0 (the MAC keys alone) included
WORDS = [0, 1, 15, 16, 17, 37, 5003]

_ref_pass = jax.jit(functools.partial(j_aead._cipher_pass, backend="jnp"))
_ref_pass_pallas = jax.jit(functools.partial(j_aead._cipher_pass,
                                             backend="pallas"))
_ref_mac_keys = jax.jit(j_aead._mac_keys_rows)
_ref_stream = jax.jit(j_aead._fused_stream, static_argnums=2)
_ref_derive = jax.jit(j_aead.derive_mac_keys)
_ref_seal = jax.jit(j_aead.seal)
_ref_open = jax.jit(j_aead.open_)


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                                dtype=np.uint32)


def _t(a):
    return from_numpy(a, CPU)


def _inputs(B, n, per_item, seed):
    return (_u32((B, 8) if per_item else 8, seed), _u32((B, 3), seed + 1),
            _u32((B, n), seed + 2))


def _same(got, want):
    return np.array_equal(to_numpy(got), np.asarray(want).astype(np.uint32))


@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("n", WORDS)
@pytest.mark.parametrize("B", BATCHES)
def test_cipher_pass_equals_reference(B, n, per_item):
    key, nonces, payload = _inputs(B, n, per_item, seed=100 * B + n)
    jmk, jct = _ref_pass(jnp.asarray(key), jnp.asarray(nonces),
                         jnp.asarray(payload))
    mk, ct = chacha_ops.cipher_pass(_t(key), _t(nonces), _t(payload))
    assert mk.shape == (B, 4) and ct.shape == (B, n)
    assert _same(mk, jmk) and _same(ct, jct)
    # no payload: the MAC keys alone, the reference's batched derivation
    mk0, none = chacha_ops.cipher_pass(_t(key), _t(nonces))
    assert none is None
    assert _same(mk0, _ref_mac_keys(jnp.asarray(key), jnp.asarray(nonces)))
    # the plain version is what the CPU op runs
    assert torch.equal(cipher_pass_ref(_t(key), _t(nonces), _t(payload))[1],
                       ct)


@pytest.mark.parametrize("per_item", [False, True])
def test_cipher_pass_equals_reference_pallas_path(per_item):
    """B x (1 + n / 16) = 8 x 32 = 256 rows: one whole tile of the
    reference's Pallas rows kernel (interpret mode)."""
    key, nonces, payload = _inputs(8, 496, per_item, seed=7)
    jmk, jct = _ref_pass_pallas(jnp.asarray(key), jnp.asarray(nonces),
                                jnp.asarray(payload))
    mk, ct = chacha_ops.cipher_pass(_t(key), _t(nonces), _t(payload))
    assert _same(mk, jmk) and _same(ct, jct)


@pytest.mark.parametrize("n", WORDS)
def test_cipher_pass_message_equals_reference(n):
    key, nonce, words = _u32(8, n), _u32(3, n + 1), _u32(n, n + 2)
    jmk, jks = _ref_stream(jnp.asarray(key), jnp.asarray(nonce), n)
    mk, ct = chacha_ops.cipher_pass_message(_t(key), _t(nonce), _t(words))
    assert mk.shape == (4,) and ct.shape == (n,)
    assert _same(mk, jnp.stack(jmk)) and _same(ct, words ^ np.asarray(jks))
    mk0, none = chacha_ops.cipher_pass_message(_t(key), _t(nonce))
    assert none is None and torch.equal(mk0, mk)
    want = _ref_derive(jnp.asarray(key), jnp.asarray(nonce))
    got = aead.derive_mac_keys(_t(key), _t(nonce))
    assert all(_same(g, w) for g, w in zip(got, want))


def test_cipher_pass_counts_dispatches_as_before():
    """One device dispatch per batched call, none for the scalar ones."""
    key, nonces, words = _inputs(3, 37, False, seed=9)
    REGISTRY.reset("device.dispatches")
    ct, tags = aead.seal_many(_t(key), _t(nonces), _t(words))
    aead.open_many(_t(key), _t(nonces), ct, tags)
    aead.derive_mac_keys_many(_t(key), _t(nonces))
    aead.seal(_t(key), _t(nonces[0]), _t(words[0]))
    aead.derive_mac_keys(_t(key), _t(nonces[0]))
    snap = REGISTRY.snapshot()
    assert snap["device.dispatches"] == 3
    assert snap["device.dispatches.aead.seal_many"] == 1
    assert snap["device.dispatches.aead.open_many"] == 1
    assert snap["device.dispatches.aead.mac_keys_many"] == 1


def test_cipher_pass_validates_operands():
    key, nonces, payload = (_t(a) for a in _inputs(3, 20, True, seed=3))
    with pytest.raises(ValueError, match="int32"):
        chacha_ops.cipher_pass(key, nonces, payload.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.cipher_pass(key[:2], nonces, payload)
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.cipher_pass(key, nonces, payload[:2])
    with pytest.raises(ValueError, match="contiguous"):
        chacha_ops.cipher_pass(key, nonces, payload[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.cipher_pass_message(key, nonces[0], payload[0])
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.cipher_pass_message(key[0], nonces, payload[0])
    with pytest.raises(ValueError, match="on"):
        chacha_ops.cipher_pass(key, nonces, payload.to("meta"))
