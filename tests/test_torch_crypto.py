"""Crypto parity of the torch port with the JAX reference on the CPU.

The same numpy inputs, made from a seed, go through the reference's
functions and the port's; every comparison is bit equality.  The port's
kernel wrappers run their plain torch versions here (CPU tensors)."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import aead as j_aead
from repro.crypto import chacha20 as j_chacha
from repro.crypto import cwmac as j_cwmac
from repro.crypto import keys as j_keys
from repro.kernels.chacha20 import ops as j_chacha_ops
from repro.kernels.cwmac import ops as j_cwmac_ops
from repro_torch.crypto import aead, chacha20, cwmac, keys
from repro_torch.kernels.chacha20 import ops as chacha_ops
from repro_torch.kernels.cwmac import ops as cwmac_ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.u32 import from_numpy, to_numpy

# RFC 7539 §2.3.2 key/nonce (word-little-endian), as in
# tests/test_aead_fastpath.py
RFC_KEY = np.array([0x03020100, 0x07060504, 0x0b0a0908, 0x0f0e0d0c,
                    0x13121110, 0x17161514, 0x1b1a1918, 0x1f1e1d1c],
                   dtype=np.uint32)
RFC_NONCE = np.array([0x09000000, 0x4a000000, 0x00000000], dtype=np.uint32)
RFC_BLOCK1 = np.array([0xe4e7f110, 0x15593bd1, 0x1fdd0f50, 0xc47120a3,
                       0xc7f4d1c7, 0x0368c033, 0x9aaa2204, 0x4e6cd4c3,
                       0x466482d2, 0x09aa9f07, 0x05d7c214, 0xa2028bd9,
                       0xd19c12b5, 0xb94e16de, 0xe883d0cb, 0x4e3c50a2],
                      dtype=np.uint32)
CPU = "cpu"


def _u32(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                                dtype=np.uint32)


def _t(a):
    return from_numpy(a, CPU)


def _j(a):
    return jnp.asarray(a)


# --------------------------------------------------------------- chacha20


def test_rfc7539_block_and_seal_keystream():
    blk = chacha20.chacha20_block(_t(RFC_KEY), _t(RFC_NONCE),
                                  _t(np.array([1], np.uint32)))
    assert np.array_equal(to_numpy(blk)[0], RFC_BLOCK1)
    # sealing zeros exposes the keystream from counter 1
    ct, _ = aead.seal_many(_t(RFC_KEY), _t(RFC_NONCE[None]),
                           torch.zeros((1, 16), dtype=torch.int32))
    assert np.array_equal(to_numpy(ct)[0], RFC_BLOCK1)


@pytest.mark.parametrize("per_row", [False, True])
def test_block_rows_bit_equal_incl_counter_wrap(per_row):
    N = 37
    key = _u32((N, 8) if per_row else 8, seed=1)
    nonces = _u32((N, 3), seed=2)
    counters = _u32(N, seed=3)
    counters[:4] = [0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 0]
    want = np.asarray(j_chacha.chacha20_block_rows(
        _j(key), _j(nonces), _j(counters)))
    got = chacha20.chacha20_block_rows(_t(key), _t(nonces), _t(counters))
    assert np.array_equal(to_numpy(got), want)


def test_encrypt_words_and_keystream_bit_equal():
    words = _u32(100, seed=4)
    want = np.asarray(j_chacha.encrypt_words(_j(RFC_KEY), _j(RFC_NONCE),
                                             _j(words), counter0=7))
    got = chacha20.encrypt_words(_t(RFC_KEY), _t(RFC_NONCE), _t(words),
                                 counter0=7)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("R", [1, 300])
def test_xor_rows_ragged_matches_padded_reference_op(R):
    """The reference op pads R to a whole 256-row tile and slices the tail
    off; the port's wrapper masks the ragged tail instead."""
    key, nonces = _u32((R, 8), seed=5), _u32((R, 3), seed=6)
    counters, rows = _u32(R, seed=7), _u32((R, 16), seed=8)
    want = np.asarray(j_chacha_ops.xor_rows(_j(key), _j(nonces),
                                            _j(counters), _j(rows)))
    got = chacha_ops.xor_rows(_t(key), _t(nonces), _t(counters), _t(rows))
    assert np.array_equal(to_numpy(got), want)
    shared = chacha_ops.xor_rows(_t(key[0]), _t(nonces), _t(counters),
                                 _t(rows))
    assert np.array_equal(to_numpy(shared), np.asarray(
        j_chacha_ops.xor_rows(_j(key[0]), _j(nonces), _j(counters),
                              _j(rows))))


def test_xor_rows_validates_operands():
    rows = torch.zeros((4, 16), dtype=torch.int32)
    ok = dict(key=torch.zeros(8, dtype=torch.int32),
              nonces=torch.zeros((4, 3), dtype=torch.int32),
              counters=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        chacha_ops.xor_rows(ok["key"].to(torch.int64), ok["nonces"],
                            ok["counters"], rows)
    with pytest.raises(ValueError, match="shape"):
        chacha_ops.xor_rows(ok["key"], ok["nonces"][:3], ok["counters"],
                            rows)
    with pytest.raises(ValueError, match="contiguous"):
        chacha_ops.xor_rows(ok["key"], ok["nonces"], ok["counters"],
                            torch.zeros((16, 4), dtype=torch.int32).t())


# ------------------------------------------------------------------ cwmac


@pytest.mark.parametrize("B,n", [(3, 1), (2, 37), (2, 2500)])
def test_mac_batch_matches_reference_and_host_oracle(B, n):
    words = _u32((B, n), seed=9)
    rs = np.random.default_rng(10).integers(0, 2 ** 31 - 1, (4, B))
    r1, s1, r2, s2 = (_t(x.astype(np.int32)) for x in rs)
    jr1, js1, jr2, js2 = (_j(x.astype(np.uint32)) for x in rs)
    # the reference's kernel path (Pallas interpret); its jnp form is
    # covered through seal_many(backend="jnp") below
    want = np.asarray(j_cwmac_ops.mac2_batch(_j(words), jr1, js1, jr2, js2))
    plain = cwmac.mac2_batch(_t(words), r1, s1, r2, s2)
    kernel_path = cwmac_ops.mac2_batch(_t(words), r1, s1, r2, s2)
    assert np.array_equal(to_numpy(plain), want)
    assert np.array_equal(to_numpy(kernel_path), want)
    for b in range(B):
        assert int(plain[b, 0]) == cwmac.mac_reference(
            words[b], int(rs[0, b]), int(rs[1, b])) == \
            j_cwmac.mac_reference(words[b], int(rs[0, b]), int(rs[1, b]))


def test_field_helpers_and_single_message_mac_match_reference():
    p = cwmac.P31
    a = np.array([0, 1, p - 1, 2 ** 30, 123456789], np.int64)
    b = np.array([p - 1, p - 1, p - 1, 2 ** 30 + 5, 987654321], np.int64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert cwmac.mulmod(ta, tb).tolist() == [int(x) * int(y) % p
                                             for x, y in zip(a, b)]
    assert cwmac.addmod(ta, tb).tolist() == [(int(x) + int(y)) % p
                                             for x, y in zip(a, b)]
    words = _u32(9, seed=30)
    assert np.array_equal(cwmac._to_limbs(_t(words)).numpy(),
                          np.asarray(j_cwmac._to_limbs(_j(words))))
    r = torch.tensor(7654321, dtype=torch.int32)
    assert np.array_equal(cwmac.r_powers(r, 10).numpy(), np.asarray(
        j_cwmac.r_powers(jnp.uint32(7654321), 10)))
    tag = cwmac.mac2(_t(words), r, torch.tensor(5), r + 1, torch.tensor(6))
    assert tag.tolist() == [cwmac.mac_reference(words, 7654321, 5),
                            cwmac.mac_reference(words, 7654322, 6)]


@pytest.mark.parametrize("B,n,strided", [
    (2, 5003, False),      # ragged: n % 4 != 0, a partial last block
    (3, 37, False),        # under one block
    (8, 16384, True),      # a window's rows, keys as (B, 4) columns
    (1, 140000, True),     # more than 8 blocks: the ticket path
    (4, 2500, True),
])
def test_mac_partials_sum_to_the_tag(B, n, strided):
    """The kernel writes finished tags: its plain version, split into the
    kernel's blocks (partials folded by Horner, s added), gives the
    reference's mac2_batch tags bit for bit, with the keys passed as the
    AEAD holds them (strided columns of the (B, 4) mac-key rows)."""
    words = _u32((B, n), seed=11)
    mk = np.random.default_rng(n).integers(0, 2 ** 31 - 1, (B, 4))
    mk[0, :2] = [2 ** 31 - 2, 0]                       # largest r, zero s
    mk_t = _t(mk.astype(np.int32))
    cols = [mk_t[:, i] if strided else mk_t[:, i].contiguous()
            for i in range(4)]
    assert cols[0].is_contiguous() is (not strided or B == 1)
    G, m, cluster = cwmac_ops.plan(n, B)
    assert cluster is (n <= 131072) and (G > 8) is (not cluster)
    tags = cwmac_ops.mac2_batch(_t(words), *cols)
    if not strided:  # the reference's kernel path (Pallas interpret)
        want = np.asarray(j_cwmac_ops.mac2_batch(_j(words), *(
            _j(mk[:, i].astype(np.uint32)) for i in range(4))))
    else:            # its host oracle (its jnp forms compile per shape)
        want = np.array([[j_cwmac.mac_reference(words[b], int(mk[b, 2 * k]),
                                                int(mk[b, 2 * k + 1]))
                          for k in range(2)] for b in range(B)])
    assert np.array_equal(to_numpy(tags), want)
    single = cwmac_ops.mac_batch(_t(words), cols[2], cols[3])
    assert np.array_equal(to_numpy(single), want[:, 1])


# ------------------------------------------------------------------- aead


@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("B,n", [(3, 16), (4, 37), (2, 1)])
def test_seal_open_many_match_reference(per_item, B, n):
    key = _u32((B, 8) if per_item else 8, seed=12)
    nonces, words = _u32((B, 3), seed=13), _u32((B, n), seed=14)
    jct, jtag = j_aead.seal_many(_j(key), _j(nonces), _j(words),
                                 backend="jnp")
    for backend in ("kernel", "torch"):
        ct, tag = aead.seal_many(_t(key), _t(nonces), _t(words),
                                 backend=backend)
        assert np.array_equal(to_numpy(ct), np.asarray(jct))
        assert np.array_equal(to_numpy(tag), np.asarray(jtag))
        pt, ok = aead.open_many(_t(key), _t(nonces), ct, tag,
                                backend=backend)
        assert np.array_equal(to_numpy(pt), words) and bool(ok.all())


def test_seal_many_matches_pallas_interpret_path():
    key, nonces, words = _u32(8, 15), _u32((2, 3), 16), _u32((2, 33), 17)
    jct, jtag = j_aead.seal_many(_j(key), _j(nonces), _j(words),
                                 backend="pallas")
    ct, tag = aead.seal_many(_t(key), _t(nonces), _t(words))
    assert np.array_equal(to_numpy(ct), np.asarray(jct))
    assert np.array_equal(to_numpy(tag), np.asarray(jtag))


def test_open_many_tamper_is_per_row():
    key, nonces, words = _u32(8, 18), _u32((4, 3), 19), _u32((4, 40), 20)
    ct, tags = aead.seal_many(_t(key), _t(nonces), _t(words))
    bad = ct.clone()
    bad[2, 5] ^= 1
    _, ok = aead.open_many(_t(key), _t(nonces), bad, tags)
    assert ok.tolist() == [True, True, False, True]
    bad_tags = tags.clone()
    bad_tags[0, 1] ^= 1
    _, ok = aead.open_many(_t(key), _t(nonces), ct, bad_tags)
    assert ok.tolist() == [False, True, True, True]


def test_mac_keys_and_mac2_many_match_reference_and_count_dispatches():
    key, nonces, words = _u32((3, 8), 21), _u32((3, 3), 22), _u32((3, 9), 23)
    REGISTRY.reset("device.dispatches")
    mk = aead.derive_mac_keys_many(_t(key), _t(nonces))
    tags = aead.mac2_many(_t(words), mk)
    jmk = j_aead.derive_mac_keys_many(_j(key), _j(nonces))
    assert np.array_equal(to_numpy(mk), np.asarray(jmk))
    assert np.array_equal(to_numpy(tags), np.asarray(
        j_aead.mac2_many(_j(words), jmk, backend="jnp")))
    snap = REGISTRY.snapshot()
    assert snap["device.dispatches"] == 2
    assert snap["device.dispatches.aead.mac_keys_many"] == 1
    assert snap["device.dispatches.aead.mac2_many"] == 1


def test_batch_validation():
    with pytest.raises(ValueError, match="int32"):
        aead.seal_many(_t(RFC_KEY), _t(RFC_NONCE[None]),
                       torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="nonces"):
        aead.seal_many(_t(RFC_KEY), _t(_u32((2, 3))), _t(_u32((3, 4))))
    with pytest.raises(ValueError, match="backend"):
        aead.seal_many(_t(RFC_KEY), _t(RFC_NONCE[None]), _t(_u32((1, 4))),
                       backend="pallas")


@pytest.mark.parametrize("dtype,shape", [("float32", (3, 5)),
                                         ("uint32", (3, 7)),
                                         ("int8", (3, 7))])
def test_framing_matches_reference(dtype, shape):
    rng = np.random.default_rng(24)
    if dtype == "float32":
        x = rng.standard_normal(shape).astype(np.float32)
        tx = torch.from_numpy(x)
    elif dtype == "uint32":
        x = _u32(shape, seed=25)
        tx = _t(x)
    else:
        x = rng.integers(-128, 128, shape).astype(np.int8)
        tx = torch.from_numpy(x)
    jw, jmeta = j_aead.tensor_to_words_batch(_j(x))
    w, meta = aead.tensor_to_words_batch(tx)
    assert np.array_equal(to_numpy(w.contiguous()), np.asarray(jw))
    assert (tuple(meta[0]), meta[1], meta[2]) == \
        (tuple(jmeta[0]), jmeta[1], jmeta[2])
    assert meta[2] == (1 if dtype == "int8" else 0)     # 7 bytes -> pad 1
    back = aead.words_to_tensor_batch(w, meta)
    assert torch.equal(back, tx)
    flat, fmeta = aead.tensor_to_words(tx[0])
    assert torch.equal(aead.words_to_tensor(flat, fmeta), tx[0])


# ------------------------------------------------------------------- keys


def test_stage_key_words_and_nonces_match_reference():
    material = hashlib.sha256(b"stage-key-material").digest()
    k = keys.StageKey(key=keys.key_words(material), stage_id=1)
    jk = j_keys.StageKey(key=np.frombuffer(material, "<u4").copy(),
                         stage_id=1)
    assert k.key.dtype == np.int32
    assert np.array_equal(k.key.view(np.uint32), jk.key)
    for c in (0, 5, 2 ** 32 + 3, keys.NONCE_COUNTER_MAX):
        assert np.array_equal(k.nonce(c).view(np.uint32), jk.nonce(c))
    with pytest.raises(keys.NonceExhaustedError):
        k.nonce(keys.NONCE_COUNTER_MAX + 1)
