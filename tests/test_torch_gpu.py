"""The torch port's CUDA kernels against their plain torch versions on
the card, bit for bit.  Every test here needs a CUDA device: it is marked
``gpu`` and skips (with the reason) where there is none.  The file imports
no JAX, so it also runs on a GPU machine without the reference package:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.crypto import aead, cwmac
from repro_torch.kernels import build
from repro_torch.kernels.chacha20 import ops as chacha_ops
from repro_torch.kernels.chacha20.ref import (chacha20_xor_blocks_ref,
                                              chacha20_xor_rows_ref)
from repro_torch.kernels.cwmac import ops as cwmac_ops
from repro_torch.kernels.cwmac.ref import (mac_partials_batch_ref,
                                           mac_partials_ref)
from repro_torch.kernels.enclave_map import ops as em_ops
from repro_torch.kernels.enclave_map.enclave_map import OPS
from repro_torch.kernels.enclave_map.ref import (enclave_apply_ref,
                                                 enclave_apply_rows_ref)
from repro_torch.u32 import from_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                                dtype=np.uint32)


# NaNs, +-0, subnormals, squares that underflow, +-inf, words >= 2^31
SPECIAL = np.array([0x7FC00000, 0x7F800001, 0xFFC00001, 0x80000000, 0, 1,
                    0x00400000, 0x80000001, 0x1F800000, 0x1FFFFFFF,
                    0x20000000, 0x7F7FFFFF, 0xFF800000, 0x7F800000,
                    0x00800000, 0x80800000, 0x80000010, 0xFFFFFFFF, 16, 15],
                   dtype=np.uint32)


def _words(rows, seed=0):
    rng = np.random.default_rng(seed)
    w = np.concatenate([
        SPECIAL, rng.integers(0, 2 ** 32, rows * 8 - len(SPECIAL),
                              dtype=np.uint32),
        rng.standard_normal(rows * 4).astype(np.float32).view(np.uint32),
        (rng.standard_normal(rows * 4) * 1e-38).astype(np.float32)
        .view(np.uint32)])
    return w.reshape(-1, 16)


@pytest.mark.parametrize("R,per_row", [(8200, False), (1037, True), (1, True)])
def test_chacha20_rows_kernel_equals_plain(cuda, R, per_row):
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key = t(_u32((R, 8) if per_row else 8, 1))
    args = (key, t(_u32((R, 3), 2)), t(_u32(R, 3)), t(_u32((R, 16), 4)))
    before = chacha_ops.KERNEL.launches
    assert torch.equal(chacha_ops.xor_rows(*args),
                       chacha20_xor_rows_ref(*args))
    assert chacha_ops.KERNEL.launches == before + 1


@pytest.mark.parametrize("B,n", [(8, 16384), (3, 5003), (2, 1)])
def test_cwmac_kernel_equals_plain(cuda, B, n):
    words = from_numpy(_u32((B, n), 5), cuda)
    mk = torch.as_tensor(np.random.default_rng(6).integers(
        0, 2 ** 31 - 1, (B, 4)), dtype=torch.int32, device=cuda)
    keys = [mk[:, i] for i in range(4)]
    assert torch.equal(cwmac_ops.mac2_batch(words, *keys),
                       cwmac.mac2_batch(words, *keys))
    r = torch.cat([keys[0], keys[2]])
    assert torch.equal(cwmac_ops.mac_partials_batch(words, r),
                       mac_partials_batch_ref(words, r,
                                              cwmac_ops.TILE_WORDS))


@pytest.mark.parametrize("op", list(OPS))
def test_enclave_kernel_equals_plain_on_adversarial_words(cuda, op):
    w = _words(rows=96)
    R = w.shape[0]
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    args = (t(_u32((R, 8), 7)), t(_u32((R, 8), 8)), t(_u32((R, 3), 9)),
            t(_u32(R, 10)))
    # encrypt the adversarial plaintext under the inbound coordinates
    rows = chacha20_xor_rows_ref(args[0], args[2], args[3], t(w))
    for c in (0.0, 0.1, -2.5, 2.0 ** 40, float("nan"), 1e-40, 15.7):
        if op == "delay_filter_u32" and not np.isfinite(c) or \
                op == "delay_filter_u32" and abs(c) > 2 ** 31:
            continue
        kw = dict(op=op, const=c, nonces_out=t(_u32((R, 3), 11)),
                  counters_out=t(_u32(R, 12)))
        assert torch.equal(em_ops.enclave_map_rows(*args, rows, **kw),
                           enclave_apply_rows_ref(*args, rows, **kw)), c
        shared = (args[0][0], args[1][0]) + args[2:]
        assert torch.equal(em_ops.enclave_map_rows(*shared, rows, op=op,
                                                   const=c),
                           enclave_apply_rows_ref(*shared, rows, op=op,
                                                  const=c)), c


@pytest.mark.parametrize("per_item", [False, True])
def test_seal_open_kernel_backend_equals_plain_backend(cuda, per_item):
    B, n = 8, 16 * 1024 + 5
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key = t(_u32((B, 8) if per_item else 8, 13))
    nonces, words = t(_u32((B, 3), 14)), t(_u32((B, n), 15))
    ct, tags = aead.seal_many(key, nonces, words)
    ct_p, tags_p = aead.seal_many(key, nonces, words, backend="torch")
    assert torch.equal(ct, ct_p) and torch.equal(tags, tags_p)
    pt, ok = aead.open_many(key, nonces, ct, tags)
    assert torch.equal(pt, words) and bool(ok.all())
    mk = aead.derive_mac_keys_many(key, nonces)
    assert torch.equal(mk, aead.derive_mac_keys_many(key, nonces,
                                                     backend="torch"))


def test_pipeline_on_the_card_goes_through_the_kernels(cuda):
    from repro_torch.configs.base import SecureStreamConfig
    from repro_torch.core.pipeline import Pipeline, Stage
    from repro_torch.data.synthetic import flight_chunks, flight_records
    from repro_torch.dsl.reducers import resolve_reducer
    fn, init = resolve_reducer("carrier_delay_stats", device=cuda)
    p = Pipeline([Stage("m", op="identity"),
                  Stage("f", op="delay_filter_u32", const=15),
                  Stage("r", op="custom", reduce_fn=fn, reduce_init=init)],
                 SecureStreamConfig(mode="enclave"), device=cuda)
    build.reset_launch_counts()
    out = p.run(flight_chunks(4096, 256, seed=1))
    counts = build.launch_counts()
    assert all(counts[k] > 0 for k in ("ss_chacha20_xor_rows",
                                       "ss_cwmac_partials",
                                       "ss_enclave_map_rows")), counts
    recs = flight_records(4096, seed=1)
    keep = recs[:, 1] > 15
    assert np.array_equal(out["count"].cpu().numpy(), np.bincount(
        recs[keep, 0], minlength=20))
    assert np.array_equal(out["sum"].cpu().numpy(), np.bincount(
        recs[keep, 0], weights=recs[keep, 1].astype(np.float64),
        minlength=20))


def test_failed_build_raises_for_a_cuda_tensor(cuda, monkeypatch):
    """No fallback: a CUDA tensor never runs the plain version."""
    def broken():
        raise build.BuildError("simulated failed build")
    monkeypatch.setattr(build, "library", broken)
    monkeypatch.setattr(chacha_ops.KERNEL, "_fn", None)
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    with pytest.raises(build.BuildError):
        chacha_ops.xor_rows(t(_u32(8, 1)), t(_u32((4, 3), 2)),
                            t(_u32(4, 3)), t(_u32((4, 16), 4)))


# ------------------------------------- the per-chunk engine's kernels (4-6)

WRAP = 2 ** 32 - 3


@pytest.mark.parametrize("N,counter0", [(1025, 0), (1025, WRAP), (37, 5),
                                        (1, WRAP)])
def test_chacha20_blocks_kernel_equals_plain(cuda, N, counter0):
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key, nonce, data = t(_u32(8, 1)), t(_u32(3, 2)), t(_u32((N, 16), 3))
    before = chacha_ops.BLOCKS_KERNEL.launches
    assert torch.equal(chacha_ops.xor_blocks(key, nonce, counter0, data),
                       chacha20_xor_blocks_ref(key, nonce, counter0, data))
    assert chacha_ops.BLOCKS_KERNEL.launches == before + 1


@pytest.mark.parametrize("n", [16384, 5003, 1])
def test_cwmac_message_kernel_equals_plain(cuda, n):
    words = from_numpy(_u32(n, 5), cuda)
    mk = torch.as_tensor(np.random.default_rng(6).integers(
        0, 2 ** 31 - 1, 4), dtype=torch.int32, device=cuda)
    r = mk[0::2].contiguous()
    before = cwmac_ops.MESSAGE_KERNEL.launches
    assert torch.equal(cwmac_ops.mac_partials(words, r),
                       mac_partials_ref(words, r, cwmac_ops.TILE_WORDS))
    assert torch.equal(cwmac_ops.mac2(words, *mk), cwmac.mac2(words, *mk))
    assert cwmac_ops.MESSAGE_KERNEL.launches == before + 2


@pytest.mark.parametrize("op", list(OPS))
def test_enclave_blocks_kernel_equals_plain_on_adversarial_words(cuda, op):
    w = _words(rows=96)
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    kin, kout, nonce = t(_u32(8, 7)), t(_u32(8, 8)), t(_u32(3, 9))
    before = em_ops.BLOCKS_KERNEL.launches
    for counter0 in (1, WRAP):
        blocks = chacha20_xor_blocks_ref(kin, nonce, counter0, t(w))
        for c in (0.0, 0.1, -2.5, 2.0 ** 40, float("nan"), 1e-40, 15.7):
            if op == "delay_filter_u32" and not np.isfinite(c) or \
                    op == "delay_filter_u32" and abs(c) > 2 ** 31:
                continue
            assert torch.equal(
                em_ops.enclave_map(kin, kout, nonce, counter0, blocks,
                                   op=op, const=c),
                enclave_apply_ref(kin, kout, nonce, counter0, blocks, op=op,
                                  const=c)), (counter0, c)
    assert em_ops.BLOCKS_KERNEL.launches > before


def test_scalar_seal_open_on_the_card_equal_the_cpu(cuda):
    key, nonce, pt = _u32(8, 13), _u32(3, 14), _u32(16384 + 5, 15)
    ct, tag = aead.seal(from_numpy(key, cuda), from_numpy(nonce, cuda),
                        from_numpy(pt, cuda))
    want_ct, want_tag = aead.seal(from_numpy(key, "cpu"),
                                  from_numpy(nonce, "cpu"),
                                  from_numpy(pt, "cpu"))
    assert torch.equal(ct.cpu(), want_ct) and torch.equal(tag.cpu(),
                                                          want_tag)
    back, ok = aead.open_(from_numpy(key, cuda), from_numpy(nonce, cuda),
                          ct, tag)
    assert bool(ok) and torch.equal(back.cpu(), from_numpy(pt, "cpu"))


@pytest.mark.parametrize("mode", ["encrypted", "enclave"])
def test_oracle_engine_on_the_card_goes_through_kernels_4_to_6(cuda, mode):
    from repro_torch.data.synthetic import flight_chunks, flight_records
    from repro_torch.dsl import stream
    sb = (stream().map("identity", name="m", workers=2)
          .filter("delay_filter_u32", const=15, name="f")
          .reduce("carrier_delay_stats", name="r").window(1).device(cuda))
    build.reset_launch_counts()
    out = sb.run(flight_chunks(4096, 256, seed=1), mode=mode)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    want = {"ss_chacha20_xor_blocks", "ss_cwmac_mac_partials"}
    if mode == "enclave":
        want.add("ss_enclave_map_blocks")
    assert {k for k, v in counts.items() if v} == want, counts
    recs = flight_records(4096, seed=1)
    keep = recs[:, 1] > 15
    assert np.array_equal(out["count"].cpu().numpy(), np.bincount(
        recs[keep, 0], minlength=20))
    assert np.array_equal(out["sum"].cpu().numpy(), np.bincount(
        recs[keep, 0], weights=recs[keep, 1].astype(np.float64),
        minlength=20))


def test_failed_build_raises_for_the_oracle_kernels(cuda, monkeypatch):
    """No fallback for the per-chunk engine's kernels either."""
    def broken():
        raise build.BuildError("simulated failed build")
    monkeypatch.setattr(build, "library", broken)
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key, nonce, blocks = t(_u32(8, 1)), t(_u32(3, 2)), t(_u32((4, 16), 4))
    for kernel, call in (
            (chacha_ops.BLOCKS_KERNEL,
             lambda: chacha_ops.xor_blocks(key, nonce, 1, blocks)),
            (cwmac_ops.MESSAGE_KERNEL,
             lambda: cwmac_ops.mac2(blocks.reshape(-1), *key[:4])),
            (em_ops.BLOCKS_KERNEL,
             lambda: em_ops.enclave_map(key, key, nonce, 1, blocks,
                                        op="identity"))):
        monkeypatch.setattr(kernel, "_fn", None)
        with pytest.raises(build.BuildError):
            call()
