"""The per-chunk engine's kernels (shared-key ChaCha20 blocks, the
single-message CW-MAC, the shared-key enclave map) and the scalar AEAD
of the torch port against the JAX reference on the CPU, bit for bit.

The reference runs its Pallas kernels in interpret mode here, as its own
tests do; the port's wrappers run their plain torch versions (CPU
tensors).  Inputs are numpy arrays made from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import aead as j_aead
from repro.kernels.chacha20 import ops as j_chacha_ops
from repro.kernels.cwmac import ops as j_cwmac_ops
from repro.kernels.enclave_map import ops as j_em_ops
from repro_torch.crypto import aead, cwmac
from repro_torch.kernels.chacha20 import ops as chacha_ops
from repro_torch.kernels.cwmac import ops as cwmac_ops
from repro_torch.kernels.cwmac.ref import mac_tags_ref
from repro_torch.kernels.enclave_map import ops as em_ops
from repro_torch.kernels.enclave_map.enclave_map import OPS
from repro_torch.obs.metrics import REGISTRY
from repro_torch.u32 import from_numpy, to_numpy

P31 = 2 ** 31 - 1

# NaNs, +-0, subnormals, squares that underflow, +-inf, words >= 2^31,
# delays on both sides of the threshold
SPECIAL = np.array([0x7FC00000, 0x7F800001, 0xFFC00001, 0x80000000, 0, 1,
                    0x00400000, 0x80000001, 0x1F800000, 0x1FFFFFFF,
                    0x20000000, 0x7F7FFFFF, 0xFF800000, 0x7F800000,
                    0x00800000, 0x80800000, 0x80000010, 0xFFFFFFFF, 16, 15],
                   dtype=np.uint32)


def _u32(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                                dtype=np.uint32)


def _t(a):
    return from_numpy(a, "cpu")


def _scalars(a):
    return [torch.tensor(int(v), dtype=torch.int32) for v in a]


# ---------------------------------------------------- ChaCha20 (kernel 4)


@pytest.mark.parametrize("n,counter0", [
    (1, 1), (16, 0), (100, 7), (16 * 37 + 5, 1),
    (16 * 9 + 3, 2 ** 32 - 3),            # the counter wraps mid-message
    (16 * 4, 2 ** 32 - 1)])
def test_encrypt_words_equals_reference(n, counter0):
    key, nonce, words = _u32(8, 1), _u32(3, 2), _u32(n, 3)
    want = np.asarray(j_chacha_ops.encrypt_words(
        jnp.asarray(key), jnp.asarray(nonce), jnp.asarray(words),
        counter0=np.uint32(counter0)))
    got = chacha_ops.encrypt_words(_t(key), _t(nonce), _t(words),
                                   counter0=counter0)
    assert np.array_equal(to_numpy(got), want)
    back = chacha_ops.decrypt_words(_t(key), _t(nonce), got,
                                    counter0=counter0)
    assert np.array_equal(to_numpy(back), words)


def test_xor_blocks_validates_its_operands():
    key, nonce = _t(_u32(8)), _t(_u32(3))
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.xor_blocks(key, nonce, 0, _t(_u32((4, 8))))
    with pytest.raises(ValueError, match="int32"):
        chacha_ops.xor_blocks(key, nonce, 0,
                              torch.zeros((4, 16), dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.xor_blocks(_t(_u32((2, 8))), nonce, 0, _t(_u32((4, 16))))


# ----------------------------------------------------- CW-MAC (kernel 5)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 16384, 5003])
def test_mac_and_mac2_equal_reference_at_its_tiles(n):
    words = _u32(n, 4)
    r1, s1, r2, s2 = np.random.default_rng(n).integers(0, P31 - 1, 4)
    got1 = int(cwmac_ops.mac(_t(words), *_scalars([r1, s1])))
    got2 = to_numpy(cwmac_ops.mac2(_t(words), *_scalars([r1, s1, r2, s2])))
    for tile in (64, 4096):               # the reference's tag is the same
        want1 = int(j_cwmac_ops.mac(jnp.asarray(words), jnp.uint32(r1),
                                    jnp.uint32(s1), tile=tile))
        assert got1 == want1
    assert got1 == cwmac.mac_reference(words, int(r1), int(s1))
    assert list(got2) == [got1, cwmac.mac_reference(words, int(r2),
                                                    int(s2))]


@pytest.mark.parametrize("tile_words", [8, 512, 2048, 4096])
def test_mac_partials_fold_to_the_same_tag_at_any_tile(tile_words):
    """The plain version of the tags kernel, split into blocks of any size,
    gives the reference's (kernel-path) tags bit for bit: the split
    changes no bit."""
    words = _u32(9000, 5)
    r = [123456789, 987654321]
    keys = torch.tensor([[r[0], 42, r[1], 7]], dtype=torch.int32)
    tags = mac_tags_ref(_t(words)[None], keys[:, 0::2], keys[:, 1::2],
                        tile_words)
    want = np.array([int(j_cwmac_ops.mac(jnp.asarray(words), jnp.uint32(k),
                                         jnp.uint32(sk)))
                     for k, sk in ((r[0], 42), (r[1], 7))])
    assert to_numpy(tags[0]).tolist() == want.tolist() == [
        cwmac.mac_reference(words, r[0], 42),
        cwmac.mac_reference(words, r[1], 7)]
    assert to_numpy(cwmac_ops.mac2(_t(words), *keys[0])).tolist() == \
        want.tolist()


# ------------------------------------------------- enclave map (kernel 6)


def _adversarial_blocks(rows=48, seed=0):
    rng = np.random.default_rng(seed)
    w = np.concatenate([
        SPECIAL, rng.integers(0, 2 ** 32, rows * 8 - len(SPECIAL),
                              dtype=np.uint32),
        rng.standard_normal(rows * 4).astype(np.float32).view(np.uint32),
        (rng.standard_normal(rows * 4) * 1e-38).astype(np.float32)
        .view(np.uint32)])
    return w.reshape(-1, 16)


@pytest.mark.parametrize("op,const", [
    ("identity", 0.0), ("scale_f32", 0.1), ("scale_f32", -2.5),
    ("relu_f32", 0.0), ("square_f32", 0.0), ("threshold_mask", -0.5),
    ("delay_filter_u32", 15.0)])
def test_enclave_map_equals_reference_on_adversarial_words(op, const):
    kin, kout, nonce = _u32(8, 6), _u32(8, 7), _u32(3, 8)
    pt = _adversarial_blocks()
    for counter0 in (1, 2 ** 32 - 3):
        ct = to_numpy(chacha_ops.encrypt_words(
            _t(kin), _t(nonce), _t(pt.reshape(-1)),
            counter0=counter0)).reshape(-1, 16)
        want = np.asarray(j_em_ops.enclave_map(
            jnp.asarray(kin), jnp.asarray(kout), jnp.asarray(nonce),
            np.uint32(counter0), jnp.asarray(ct), op=op, const=const,
            block_rows=pt.shape[0]))
        got = em_ops.enclave_map(_t(kin), _t(kout), _t(nonce), counter0,
                                 _t(ct), op=op, const=const)
        assert np.array_equal(to_numpy(got), want), counter0
        # re-encrypted under kout at the same nonce and counters
        y = to_numpy(chacha_ops.decrypt_words(
            _t(kout), _t(nonce), got.reshape(-1), counter0=counter0))
        assert np.array_equal(y.reshape(-1, 16), to_numpy(
            OPS[op](_t(pt), const)))


def test_enclave_map_ragged_blocks_and_dispatch_counts():
    kin, kout, nonce = _u32(8, 9), _u32(8, 10), _u32(3, 11)
    ct = _u32((37, 16), 12)                 # 37 blocks: no tile multiple
    want = np.asarray(j_em_ops.enclave_map(
        jnp.asarray(kin), jnp.asarray(kout), jnp.asarray(nonce), 5,
        jnp.asarray(np.pad(ct, ((0, 27), (0, 0)))), op="scale_f32",
        const=1.5, block_rows=64))[:37]
    d0 = REGISTRY.counter("device.dispatches.enclave_map").value
    got = em_ops.enclave_map(_t(kin), _t(kout), _t(nonce), 5, _t(ct),
                             op="scale_f32", const=1.5)
    assert np.array_equal(to_numpy(got), want)
    assert REGISTRY.counter("device.dispatches.enclave_map").value == d0 + 1
    with pytest.raises(ValueError, match="unknown enclave op"):
        em_ops.enclave_map(_t(kin), _t(kout), _t(nonce), 5, _t(ct),
                           op="nope")


# ---------------------------------------------------------- scalar AEAD


@pytest.mark.parametrize("n", [1, 16, 1000, 16384])
def test_scalar_seal_open_and_mac_keys_equal_reference(n):
    key, nonce, pt = _u32(8, 13), _u32(3, 14), _u32(n, 15)
    jk, jn = jnp.asarray(key), jnp.asarray(nonce)
    want_ct, want_tag = j_aead.seal(jk, jn, jnp.asarray(pt))
    ct, tag = aead.seal(_t(key), _t(nonce), _t(pt))
    assert np.array_equal(to_numpy(ct), np.asarray(want_ct))
    assert np.array_equal(to_numpy(tag), np.asarray(want_tag))
    mk = [int(v) for v in aead.derive_mac_keys(_t(key), _t(nonce))]
    assert mk == [int(v) for v in j_aead.derive_mac_keys(jk, jn)]
    back, ok = aead.open_(_t(key), _t(nonce), ct, tag)
    assert bool(ok) and np.array_equal(to_numpy(back), pt)
    # one tampered word, or a tampered tag, fails the open as it does in
    # the reference
    bad = to_numpy(ct).copy()
    bad[n // 2] ^= 1
    _, ok = aead.open_(_t(key), _t(nonce), _t(bad), tag)
    _, j_ok = j_aead.open_(jk, jn, jnp.asarray(bad), want_tag)
    assert not bool(ok) and not bool(j_ok)
    bad_tag = to_numpy(tag).copy()
    bad_tag[1] ^= 4
    _, ok = aead.open_(_t(key), _t(nonce), ct, _t(bad_tag))
    assert not bool(ok)


def test_scalar_aead_counts_no_dispatches_and_checks_operands():
    d0 = REGISTRY.counter("device.dispatches").value
    ct, tag = aead.seal(_t(_u32(8)), _t(_u32(3)), _t(_u32(40)))
    aead.open_(_t(_u32(8)), _t(_u32(3)), ct, tag)
    assert REGISTRY.counter("device.dispatches").value == d0
    with pytest.raises(ValueError, match="nonce"):
        aead.seal(_t(_u32(8)), _t(_u32(4)), _t(_u32(40)))
    with pytest.raises(ValueError, match="int32"):
        aead.seal(_t(_u32(8)), _t(_u32(3)),
                  torch.zeros(40, dtype=torch.float32))
