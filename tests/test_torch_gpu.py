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
                                              chacha20_xor_rows_ref,
                                              cipher_pass_ref)
from repro_torch.kernels.cwmac import ops as cwmac_ops
from repro_torch.kernels.cwmac.ref import mac_tags_ref
from repro_torch.kernels.enclave_map import ops as em_ops
from repro_torch.kernels.enclave_map.enclave_map import OPS
from repro_torch.kernels.enclave_map.ref import (enclave_apply_ref,
                                                 enclave_apply_rows_ref,
                                                 enclave_map_window_ref)
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


@pytest.mark.parametrize("B,n", [(8, 16384), (8, 4096), (3, 5003), (2, 1),
                                 (3, 37), (2, 140000), (1, 0)])
def test_cwmac_kernel_equals_plain(cuda, B, n):
    """Tags bit-equal to the plain versions at the window shapes, a
    ragged n, n under one block and n over more than 8 blocks (the ticket
    path), with the keys as strided (B, 4) columns; called twice in a row
    (the tickets are zero again after each launch)."""
    words = from_numpy(_u32((B, n), 5), cuda)
    mk = torch.as_tensor(np.random.default_rng(6).integers(
        0, 2 ** 31 - 1, (B, 4)), dtype=torch.int32, device=cuda)
    keys = [mk[:, i] for i in range(4)]
    want = cwmac.mac2_batch(words, *keys)
    assert torch.equal(want, mac_tags_ref(words, mk[:, 0::2], mk[:, 1::2],
                                          cwmac_ops.block_words(n, B)))
    before = cwmac_ops.KERNEL.launches
    for _ in range(2):
        assert torch.equal(cwmac_ops.mac2_batch(words, *keys), want)
    assert torch.equal(cwmac_ops.mac_batch(words, keys[2], keys[3]),
                       want[:, 1])
    assert cwmac_ops.KERNEL.launches == before + 3


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


@pytest.mark.parametrize("op", list(OPS))
def test_enclave_window_kernel_equals_plain_on_adversarial_words(cuda, op):
    """The window hop's entry on ciphertext that decrypts to adversarial
    words, at the window shapes and ragged n, shared and per-item keys,
    with and without outbound nonces, on aligned payloads and on payloads
    a word into their buffer (the word-wise path); one launch a call."""
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    flat = _words(rows=2560).reshape(-1)
    before, calls = em_ops.WINDOW_KERNEL.launches, 0
    for B, n in ((8, 4096), (3, 37), (1, 1), (2, 17), (3, 5003), (2, 15)):
        buf = t(flat[:B * n + 1])
        nonces, nout = t(_u32((B, 3), n)), t(_u32((B, 3), n + 1))
        for kin, kout in ((t(_u32(8, 7)), t(_u32(8, 8))),
                          (t(_u32((B, 8), 9)), t(_u32((B, 8), 10)))):
            for pt in (buf[:B * n].reshape(B, n), buf[1:].reshape(B, n)):
                words = cipher_pass_ref(kin, nonces, pt)[1]
                if pt.storage_offset():      # the same words, unaligned
                    words = torch.cat([words.new_zeros(1),
                                       words.reshape(-1)])[1:].view(B, n)
                for c in (0.0, -2.5, float("nan"), 15.7):
                    if op == "delay_filter_u32" and not np.isfinite(c):
                        continue
                    for no in (None, nout):
                        kw = dict(op=op, const=c, nonces_out=no)
                        assert torch.equal(
                            em_ops.enclave_map_window(kin, kout, nonces,
                                                      words, **kw),
                            enclave_map_window_ref(kin, kout, nonces, words,
                                                   **kw)), (B, n, c)
                        calls += 1
    assert em_ops.WINDOW_KERNEL.launches == before + calls


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
    assert all(counts[k] > 0 for k in ("ss_chacha20_cipher_pass",
                                       "ss_cwmac_tags",
                                       "ss_enclave_map_window")), counts
    assert counts["ss_enclave_map_rows"] == 0, counts
    recs = flight_records(4096, seed=1)
    keep = recs[:, 1] > 15
    assert np.array_equal(out["count"].cpu().numpy(), np.bincount(
        recs[keep, 0], minlength=20))
    assert np.array_equal(out["sum"].cpu().numpy(), np.bincount(
        recs[keep, 0], weights=recs[keep, 1].astype(np.float64),
        minlength=20))


def test_enclave_chaos_run_on_the_card_equals_the_cpu(cuda):
    """A small enclave job under a crash (after the share ran), a tamper
    and a dropped verdict: the card's terminal sum is the CPU's, bit for
    bit, and its re-executions went through the window hop's kernel."""
    from repro_torch.attest.directory import KeyDirectory
    from repro_torch.configs.base import SecureStreamConfig
    from repro_torch.core.pipeline import Pipeline, Stage
    from repro_torch.ft import ChaosPlan, FaultSpec, RetryPolicy

    def add(acc, x):
        return x if acc is None else acc + x

    xs = [np.random.default_rng(i).standard_normal(4096)
          .astype(np.float32) for i in range(16)]

    def run(dev):
        plan = ChaosPlan(faults=[
            FaultSpec("crash", stage="a", round=0, worker=1, when="after"),
            FaultSpec("tamper", stage="b", round=1, worker=0, rows=2),
            FaultSpec("drop_verdict", stage="a", round=1, worker=0)])
        p = Pipeline([Stage("a", "scale_f32", const=1.5, workers=2),
                      Stage("b", "relu_f32"),
                      Stage("sum", "custom", reduce_fn=add)],
                     SecureStreamConfig(mode="enclave"), seed=3,
                     directory=KeyDirectory(seed=3, epoch_history=64),
                     window_chunks=4, device=dev,
                     retry=RetryPolicy(share_timeout_s=0.25), chaos=plan)
        out = p.run(iter(torch.as_tensor(x, device=dev) for x in xs))
        assert not plan.pending()
        return out.cpu().numpy(), p.directory.audit.dump()

    build.reset_launch_counts()
    got, audit = run(cuda)
    assert build.launch_counts()["ss_enclave_map_window"] > 0
    want, want_audit = run("cpu")
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert audit == want_audit


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


@pytest.mark.parametrize("n", [16384, 5003, 1, 37, 140000])
def test_cwmac_message_kernel_equals_plain(cuda, n):
    words = from_numpy(_u32(n, 5), cuda)
    mk = torch.as_tensor(np.random.default_rng(6).integers(
        0, 2 ** 31 - 1, 4), dtype=torch.int32, device=cuda)
    want = cwmac.mac2(words, *mk)
    before = cwmac_ops.MESSAGE_KERNEL.launches
    for _ in range(2):             # the ticket path resets its tickets
        assert torch.equal(cwmac_ops.mac2(words, *mk), want)
    assert torch.equal(cwmac_ops.mac(words, mk[0], mk[1]), want[0])
    assert cwmac_ops.MESSAGE_KERNEL.launches == before + 3


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
    want = {"ss_chacha20_cipher_pass", "ss_cwmac_mac_tags"}
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


# ------------------------ the AEAD's cipher pass (kernels 1 and 4's entry)

PASS_WORDS = [0, 1, 15, 16, 17, 37, 5003, 16384]


@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("n", PASS_WORDS)
@pytest.mark.parametrize("B", [1, 3, 8])
def test_cipher_pass_kernel_equals_plain(cuda, B, n, per_item):
    """One launch a call, bit-equal to the plain version: the window's
    seal (8 x 16384), ragged and unaligned n, n = 0 (MAC keys alone)."""
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key = t(_u32((B, 8) if per_item else 8, n + 1))
    nonces, payload = t(_u32((B, 3), n + 2)), t(_u32((B, n), n + 3))
    before = chacha_ops.PASS_KERNEL.launches
    mk, ct = chacha_ops.cipher_pass(key, nonces, payload)
    want_mk, want_ct = cipher_pass_ref(key, nonces, payload)
    assert torch.equal(mk, want_mk) and torch.equal(ct, want_ct)
    mk0, none = chacha_ops.cipher_pass(key, nonces)
    assert none is None and torch.equal(mk0, want_mk)
    assert chacha_ops.PASS_KERNEL.launches == before + 2


@pytest.mark.parametrize("n", PASS_WORDS)
def test_cipher_pass_message_kernel_equals_plain(cuda, n):
    """The single-message entry, on an aligned message and on one that
    starts 4 bytes into its buffer (the word-wise path)."""
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key, nonce, buf = t(_u32(8, n + 4)), t(_u32(3, n + 5)), t(_u32(n + 1,
                                                                  n + 6))
    for words in (buf[:n], buf[1:]):
        mk, ct = chacha_ops.cipher_pass_message(key, nonce, words)
        want_mk, want_ct = cipher_pass_ref(key, nonce[None], words[None])
        assert torch.equal(mk, want_mk[0]) and torch.equal(ct, want_ct[0])
    mk0, none = chacha_ops.cipher_pass_message(key, nonce)
    assert none is None and torch.equal(mk0, want_mk[0])


def test_cipher_pass_message_of_100_mb_equals_plain(cuda):
    """100 MB under one key: the words at three offsets against the plain
    blocks version from the same counters (block j at counter j)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    words = torch.randint(-2 ** 31, 2 ** 31, ((100 << 20) // 4,),
                          dtype=torch.int32, device=cuda, generator=g)
    key, nonce = from_numpy(_u32(8, 1), cuda), from_numpy(_u32(3, 2), cuda)
    mk, ct = chacha_ops.cipher_pass_message(key, nonce, words)
    assert torch.equal(mk, cipher_pass_ref(key, nonce[None])[0][0])
    blocks = words.reshape(-1, 16)
    for off in (0, blocks.shape[0] // 2, blocks.shape[0] - 4096):
        want = chacha20_xor_blocks_ref(key, nonce, 1 + off,
                                       blocks[off:off + 4096])
        assert torch.equal(ct.reshape(-1, 16)[off:off + 4096], want), off


def _device_kernels(fn):
    """Names of the kernels ``fn()`` runs on the card (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                    # warm: build, load, pools
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def test_aead_calls_run_one_chacha20_kernel_and_no_glue(cuda):
    """seal_many, derive_mac_keys_many and the scalar seal each run ONE
    ChaCha20 kernel on the card, and nothing else but the MAC's kernel:
    no pad, arange, repeat, zeros, clamp or copy kernel around it."""
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key, nonces, words = t(_u32(8, 1)), t(_u32((8, 3), 2)), t(_u32(
        (8, 16384), 3))
    for what, fn, mac in (
            ("seal_many", lambda: aead.seal_many(key, nonces, words), 1),
            ("derive_mac_keys_many",
             lambda: aead.derive_mac_keys_many(key, nonces), 0),
            ("seal", lambda: aead.seal(key, nonces[0], words[0]), 1)):
        names = _device_kernels(fn)
        assert sum("chacha20" in k for k in names) == 1, (what, names)
        assert sum("cwmac" in k for k in names) == mac, (what, names)
        assert len(names) == 1 + mac, (what, names)


def test_failed_build_raises_for_the_cipher_pass(cuda, monkeypatch):
    """No fallback: the cipher pass on a CUDA tensor launches or raises."""
    def broken():
        raise build.BuildError("simulated failed build")
    monkeypatch.setattr(build, "library", broken)
    monkeypatch.setattr(chacha_ops.PASS_KERNEL, "_fn", None)
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    with pytest.raises(build.BuildError):
        chacha_ops.cipher_pass(t(_u32(8, 1)), t(_u32((4, 3), 2)),
                               t(_u32((4, 40), 3)))
    with pytest.raises(build.BuildError):
        aead.derive_mac_keys(t(_u32(8, 1)), t(_u32(3, 2)))


# ----------------------- kernel 7 (flash attention) and the serving path

FLASH_CASES = [   # (B, H, Sq, Skv, dtype, causal)
    (8, 32, 4096, 4096, torch.bfloat16, True),   # the serving prefill's
    (8, 32, 4096, 4096, torch.float32, True),
    (2, 32, 1000, 1000, torch.bfloat16, False),  # a ragged tail
    (2, 32, 1000, 1000, torch.float32, True),
    (2, 32, 128, 128, torch.bfloat16, True),
    (1, 32, 100, 300, torch.bfloat16, True),     # Sq < Skv, top-left mask
    (1, 32, 100, 300, torch.float32, False),
    (1, 32, 4097, 4097, torch.bfloat16, True),   # decode's prefill(S + 1)
    (2, 8, 200, 200, torch.bfloat16, True),      # Sq not a multiple of 128
    (1, 4, 130, 700, torch.bfloat16, True),      # Sq < Skv, ragged both
    (1, 4, 130, 700, torch.bfloat16, False),
]
#: f32 (the algorithm check) within max-abs 2e-5; bf16 within the bound
#: that scales with the values, ``ref.bf16_mismatch``
F32_TOL = 2e-5


def _assert_flash_close(got, want, q, k, v, causal):
    from repro_torch.kernels.flash_attention import ref
    if got.dtype == torch.float32:
        assert (got - want).abs().max().item() <= F32_TOL
        return
    max_abs, excess, row_rel = ref.bf16_mismatch(got, want, q, k, v,
                                                 causal=causal)
    assert excess <= 0 and row_rel <= ref.BF16_ROW_RTOL, (max_abs, excess,
                                                          row_rel)


def _qkv(cuda, B, H, Sq, Skv, dtype, seed=0, D=64):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((B, H, s, D), generator=g, device=cuda).to(dtype)
            for s in (Sq, Skv, Skv)]


@pytest.mark.parametrize("B,H,Sq,Skv,dtype,causal", FLASH_CASES)
def test_flash_kernel_equals_plain(cuda, B, H, Sq, Skv, dtype, causal):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _qkv(cuda, B, H, Sq, Skv, dtype, seed=Sq + Skv)
    before = flash_ops.KERNEL.launches
    got = flash_ops.flash_attention_bhsd(q, k, v, causal=causal)
    assert flash_ops.KERNEL.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_flash_close(got, want, q, k, v, causal)


def test_flash_kernel_reads_the_model_layout_through_strides(cuda):
    """(B, S, H, D) views with a head stride (a slice of wider heads) go
    in as they are: no copy, same result as the plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    wide = [t.transpose(1, 2) for t in _qkv(cuda, 2, 12, 333, 333,
                                            torch.bfloat16, seed=3)]
    q, k, v = (t[:, :, 2:10] for t in wide)        # (2, 333, 8, 64) views
    assert not q.is_contiguous()
    got = flash_ops.flash_attention(q, k, v)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    want = attention_ref(q, k, v)
    _assert_flash_close(got.transpose(1, 2), want, q, k, v, True)


def test_flash_wrapper_refuses_on_the_card(cuda):
    """A dtype or device the kernel does not take raises and launches
    nothing; rows TMA cannot read (72 bytes) and a D stride other than 1
    are no longer refused: the kernel runs on zero-padded copies, once."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _qkv(cuda, 1, 2, 64, 64, torch.bfloat16)
    before = flash_ops.KERNEL.launches
    for bad in ((q.half(), k.half(), v.half()),              # dtype
                (q, k.cpu(), v)):                           # device mix
        with pytest.raises(ValueError):
            flash_ops.flash_attention_bhsd(*bad)
    assert flash_ops.KERNEL.launches == before
    for odd in ((q[..., :36], k[..., :36], v[..., :36]),    # 72-byte rows
                tuple(t.transpose(2, 3).contiguous().transpose(2, 3)
                      for t in (q, k, v))):                 # D stride
        got = flash_ops.flash_attention_bhsd(*odd)
        _assert_flash_close(got, attention_ref(*odd), *odd, True)
    assert flash_ops.KERNEL.launches == before + 2


def test_failed_build_raises_for_the_flash_kernel(cuda, monkeypatch):
    from repro_torch.kernels.flash_attention import ops as flash_ops

    def broken():
        raise build.BuildError("simulated failed build")
    monkeypatch.setattr(build, "library", broken)
    monkeypatch.setattr(flash_ops.KERNEL, "_fn", None)
    with pytest.raises(build.BuildError):
        flash_ops.flash_attention_bhsd(*_qkv(cuda, 1, 2, 64, 64,
                                             torch.bfloat16))


#: kernel 7's log-sum-exp against the plain version's, f32 both (values
#: ~log(keys)): f32 sums in another order, ex2.approx, the exp2-unit max
#: times ln 2
LSE_TOL = 1e-4


@pytest.mark.parametrize("B,H,Sq,Skv,dtype,causal", [
    (2, 32, 1000, 1000, torch.bfloat16, True),
    (2, 32, 1000, 1000, torch.float32, True),
    (1, 4, 130, 700, torch.bfloat16, False),
    (1, 4, 200, 200, torch.float32, False),
    (4, 32, 2048, 2048, torch.bfloat16, True),   # llama3.2-1b training
])
def test_flash_kernel_lse_equals_plain(cuda, B, H, Sq, Skv, dtype, causal):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _qkv(cuda, B, H, Sq, Skv, dtype, seed=Sq + 7)
    before = flash_ops.KERNEL.launches
    got, lse = flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                              return_lse=True)
    assert flash_ops.KERNEL.launches == before + 1
    want, want_lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    _assert_flash_close(got, want, q, k, v, causal)
    # the model layout gives the same head-major lse
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    _, lse2 = flash_ops.flash_attention(qs, ks, vs, causal=causal,
                                        return_lse=True)
    assert torch.equal(lse2, lse)


@pytest.mark.parametrize("S,qc,kc", [(2048, 512, 1024), (384, 128, 128)])
def test_flash_function_gradients_equal_plain_autograd(cuda, S, qc, kc):
    """The training attention on the card: kernel 7 (with its lse) in the
    forward, kernel 8 (its three launches) in the backward, against autograd
    through plain f32 attention of the same bf16 inputs: each gradient
    within 1e-2 relative L2 (bf16 output and gradients, 2^-9 each)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.flash import flash_attention
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn((2, S, 8, 64), generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    before = build.launch_counts()
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*x, True, qc, kc), x, do)
    ran = {n: c - before[n] for n, c in build.launch_counts().items()}
    assert ran["ss_flash_attention_fwd"] == 1
    for name in BWD_KERNELS:
        assert ran[name] == 1, (name, ran)
    y = [t.float().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", y[0], y[1]) / 8.0
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                 device=cuda).triu(1), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), y[2])
    want = torch.autograd.grad(out, y, do.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        rel = ((a.float() - b).norm() / b.norm()).item()
        assert rel <= 1e-2, rel


#: kernel 8's launches, one each a backward
BWD_KERNELS = ("ss_flash_attention_bwd_preprocess", "ss_flash_attention_bwd",
               "ss_flash_attention_bwd_convert")
#: kernel 8's gradients against the plain backward's and autograd's through
#: plain f32 attention, relative L2: its outputs are bf16 (2^-9 each), its
#: p and ds are rounded to bf16 before their products (as kernel 7's p
#: before P V), and dQ's f32 atomic adds run in an order that changes from
#: run to run
BWD_RTOL = 1e-2


def _autograd_attention(q, k, v, do, causal):
    """Autograd through plain f32 attention of (B, S, H, D) inputs (the
    bf16 values, upcast) -> (dq, dk, dv) in f32."""
    y = [t.float().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", y[0], y[1]) / q.shape[3] ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                                     device=q.device).triu(1), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), y[2])
    return torch.autograd.grad(out, y, do.float())


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _kernel8(q, k, v, do, causal):
    """Kernel 7's forward (out, lse), then kernel 8 -> (grads, out, lse),
    each of kernel 8's launches counted once."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    out, lse = flash_ops.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
    before = build.launch_counts()
    grads = flash_ops.flash_attention_backward(q, k, v, out, lse, do,
                                               causal=causal)
    after = build.launch_counts()
    assert all(after[n] == before[n] + 1 for n in BWD_KERNELS)
    for g, t in zip(grads, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
    return grads, out, lse


@pytest.mark.parametrize("B,S,H,D,causal", [
    (3, 2048, 32, 64, True),      # musicgen-selfattn-2.4b.sealed-train's
    (12, 512, 32, 64, True),      # its s512 cell's
    (2, 384, 8, 64, False),
    (2, 1000, 4, 64, True),       # ragged: the last Q and KV tiles part-full
    (1, 1000, 4, 128, False),
    (2, 384, 4, 16, True),        # padded widths: 16 and 112 at Dp 64, 128
    (2, 1000, 4, 112, True),
    (2, 384, 4, 128, True),
    (1, 333, 3, 20, True),        # D = 20: rows TMA cannot read, padded to 24
])
def test_flash_backward_kernel_equals_plain(cuda, B, S, H, D, causal):
    """Kernel 8 against ``flash_backward_plain`` (the f32 block
    recompute, from the same out and lse) and against autograd through
    plain f32 attention of the same bf16 inputs: each gradient within
    BWD_RTOL relative L2."""
    from repro_torch.models.flash import flash_backward_plain
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    got, out, lse = _kernel8(q, k, v, do, causal)
    chunks = (512, 1024) if S % 512 == 0 else (S, S)
    plain = flash_backward_plain(q, k, v, out, lse, do, causal, *chunks)
    want = _autograd_attention(q, k, v, do, causal)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert _rel(a, p) <= BWD_RTOL, (name, _rel(a, p))
        assert _rel(a, w) <= BWD_RTOL, (name, _rel(a, w))


@pytest.mark.parametrize("S,causal", [(2048, True), (1000, False)])
def test_flash_backward_kernel_is_deterministic_when_asked(cuda, S, causal):
    """Under ``torch.use_deterministic_algorithms(True)`` kernel 8 stores
    each 64 keys' dQ sums apart and adds them in order: two backwards give
    the same bits, within BWD_RTOL of the default path (whose f32 adds run
    in any order) and of autograd's."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn((2, S, 8, 64), generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    fast, _, _ = _kernel8(q, k, v, do, causal)
    torch.use_deterministic_algorithms(True)
    try:
        once, _, _ = _kernel8(q, k, v, do, causal)
        again, _, _ = _kernel8(q, k, v, do, causal)
    finally:
        torch.use_deterministic_algorithms(False)
    want = _autograd_attention(q, k, v, do, causal)
    for name, a, b, f, w in zip(("dq", "dk", "dv"), once, again, fast, want):
        assert torch.equal(a, b), name
        assert _rel(a, f) <= BWD_RTOL and _rel(a, w) <= BWD_RTOL, name


@pytest.mark.parametrize("kv_heads", [4, 1])
def test_flash_backward_kernel_takes_grouped_kv_heads(cuda, kv_heads):
    """K and V repeated from 4 KV heads to 32 (``layers.repeat_kv``, a
    copy) and from one (a stride-0 view, read as it is): dK and dV per
    query head, summed over each group by autograd, against autograd
    through plain f32 attention of the grouped inputs."""
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import repeat_kv
    B, S, H, D = 2, 640, 32, 64
    g = torch.Generator(device=cuda).manual_seed(kv_heads)
    q, do = (torch.randn((B, S, H, D), generator=g, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, kv_heads, D), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    groups = H // kv_heads
    kk, vv = (repeat_kv(t, groups) if kv_heads > 1
              else t.expand(B, S, H, D) for t in x[1:])
    before = build.launch_counts()["ss_flash_attention_bwd"]
    got = torch.autograd.grad(flash_attention(x[0], kk, vv, True, 128, 128),
                              x, do)
    assert build.launch_counts()["ss_flash_attention_bwd"] == before + 1
    y = [t.float().requires_grad_() for t in (q, k, v)]
    ks, vs = (t.repeat_interleave(groups, dim=2) for t in y[1:])
    s = torch.einsum("bqhd,bkhd->bhqk", y[0], ks) / D ** 0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                 device=cuda).triu(1), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vs)
    want = torch.autograd.grad(out, y, do.float())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and _rel(a, w) <= BWD_RTOL, (name,
                                                               _rel(a, w))


def test_flash_backward_kernel_refuses_and_the_plain_path_is_counted(cuda):
    """The wrapper raises, launching nothing, for f32 and D > 128 (the
    inputs its caller keeps on the plain backward) and for an lse of the
    wrong layout; through the Function, an f32 backward takes the plain
    path and counts it in ``plain_backwards``, a bf16 one launches
    kernel 8 and counts nothing."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import flash
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, 256, 2, 64), generator=g, device=cuda) \
        .to(torch.bfloat16)
    out, lse = flash_ops.flash_attention(q, q, q, return_lse=True)
    wide = torch.zeros((1, 256, 2, 160), dtype=torch.bfloat16, device=cuda)
    wide_lse = torch.zeros((1, 2, 256), device=cuda)
    before = build.launch_counts()
    bad_cases = [
        (q.float(), q.float(), q.float(), out.float(), lse, q.float()),
        (wide, wide, wide, wide, wide_lse, wide),
        (q, q, q, out, lse.transpose(1, 2).contiguous().transpose(1, 2), q),
        (q, q, q, out, lse[:, :1], q)]
    for args in bad_cases:
        with pytest.raises(ValueError):
            flash_ops.flash_attention_backward(*args)
    assert build.launch_counts() == before
    for dtype, plain in ((torch.float32, 1), (torch.bfloat16, 0)):
        x = q.to(dtype).requires_grad_()
        counted = flash.plain_backwards
        flash.flash_attention(x, x, x, True, 128, 128).float().sum() \
            .backward()
        assert flash.plain_backwards == counted + plain
        assert torch.isfinite(x.grad.float()).all()
    ran = {n: c - before[n] for n, c in build.launch_counts().items()}
    assert all(ran[n] == 1 for n in BWD_KERNELS), ran


def test_pallas_flash_has_no_backward_on_the_card(cuda):
    from repro_torch.models import layers
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(arch_id="t", family="dense", num_layers=1,
                      d_model=128, num_heads=2, num_kv_heads=1, d_ff=256,
                      vocab_size=64, head_dim=64)
    p = {k: (torch.randn(s.shape, device=cuda) * 0.05).to(torch.bfloat16)
         .requires_grad_() for k, s in layers.attention_template(cfg).items()}
    x = torch.randn((1, 128, 128), device=cuda).to(torch.bfloat16)
    pos = torch.arange(128, device=cuda)[None]
    y = layers.mha(p, x, cfg, positions=pos, attn_impl="pallas_flash")
    with pytest.raises(NotImplementedError, match="no backward"):
        y.float().sum().backward()
    y = layers.mha(p, x, cfg, positions=pos, attn_impl="flash")
    y.float().sum().backward()
    assert torch.isfinite(p["wq"].grad.float()).all()


def test_prefill_launches_kernel_7_once_per_layer_and_decode_never(cuda):
    """A small dense model (head_dim 64) on the card: one kernel-7 launch
    per layer in the prefill, none in decode, and logits equal to the
    same model on the CPU (plain versions) within the bf16 tolerance of
    tests/test_torch_lm.py."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import api
    cfg = ModelConfig(arch_id="gpu-test", family="dense", num_layers=3,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=1000, head_dim=64, tie_embeddings=True)
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(1),
                             cuda)
    toks = torch.randint(0, 1000, (2, 200), device=cuda, dtype=torch.int32,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    build.reset_launch_counts()
    logits, cache = api.prefill(cfg, params, {"tokens": toks}, max_seq=201)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.launch_counts().items() if v} == {
        "ss_flash_attention_fwd": 3}
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    build.reset_launch_counts()
    logits2, _ = api.decode_step(cfg, params, nxt, 200, cache)
    torch.cuda.synchronize()
    assert not any(build.launch_counts().values())
    def cpu(tree):
        return {k: cpu(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree.cpu()
    want, _ = api.prefill(cfg, cpu(params), {"tokens": toks.cpu()},
                          max_seq=201)
    assert logits.dtype == torch.float32
    excess = (logits.cpu() - want).abs() - (3e-2 + 2 ** -6 * want.abs())
    assert excess.max().item() <= 0
    assert torch.isfinite(logits2).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 32, 64, 96, 112, 128])
def test_flash_kernel_at_each_head_dim_equals_plain(cuda, D, dtype):
    """The configs' head dims and two others (32 and 96, computed at the
    padded widths 64 and 128), causal and not, ragged
    Sq < Skv, with its log-sum-exp, head-major and through (B, S, H, D)
    views with a head stride (a slice of wider heads)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for B, H, Sq, Skv, causal in ((2, 4, 333, 333, True),
                                  (1, 3, 130, 700, False),
                                  (1, 2, 1000, 1000, True)):
        q, k, v = _qkv(cuda, B, H, Sq, Skv, dtype, seed=D + Sq, D=D)
        want, want_lse = attention_ref(q, k, v, causal=causal,
                                       return_lse=True)
        before = flash_ops.KERNEL.launches
        got, lse = flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                                  return_lse=True)
        assert flash_ops.KERNEL.launches == before + 1
        _assert_flash_close(got, want, q, k, v, causal)
        assert (lse - want_lse).abs().max().item() <= LSE_TOL
    wide = [t.transpose(1, 2) for t in _qkv(cuda, 2, 10, 257, 257, dtype,
                                            seed=D, D=D)]
    q, k, v = (t[:, :, 3:9] for t in wide)          # (2, 257, 6, D) views
    assert not q.is_contiguous()
    got = flash_ops.flash_attention(q, k, v)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    _assert_flash_close(got.transpose(1, 2), attention_ref(q, k, v),
                        q, k, v, True)


def test_flash_kernel_refuses_head_dim_160(cuda):
    """D = 160 is no longer refused: the wide kernel (128 < D <= 256) runs
    it, once, against the plain version; a head dim above 256 raises
    ValueError naming the limit, launches nothing and is not handed to the
    plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _qkv(cuda, 1, 2, 64, 64, torch.bfloat16, D=160)
    before = flash_ops.KERNEL.launches
    _assert_flash_close(flash_ops.flash_attention_bhsd(q, k, v),
                        attention_ref(q, k, v), q, k, v, True)
    assert flash_ops.KERNEL.launches == before + 1
    q, k, v = _qkv(cuda, 1, 2, 64, 64, torch.bfloat16, D=264)
    with pytest.raises(ValueError, match=r"1 <= D <= 256"):
        flash_ops.flash_attention_bhsd(q, k, v)
    with pytest.raises(ValueError, match="head dim 264"):
        flash_ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    assert flash_ops.KERNEL.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [20, 100, 192, 256])
def test_flash_kernel_at_padded_and_wide_head_dims_equals_plain(cuda, D,
                                                                dtype):
    """D = 20 and 100 (bf16 rows of 40 and 200 bytes: the wrapper pads the
    copies it hands TMA to 24 and 104 columns at the real D's scale) and
    D = 192 and 256 (the wide kernel), causal and not, ragged Sq < Skv,
    with the lse (within LSE_TOL), one launch a call; and at 4 x 16 x
    2,048 (the phase 14a shape), causal."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for B, H, Sq, Skv, causal in ((2, 4, 333, 333, True),
                                  (1, 3, 130, 700, False),
                                  (4, 16, 2048, 2048, True)):
        q, k, v = _qkv(cuda, B, H, Sq, Skv, dtype, seed=D + Sq, D=D)
        want, want_lse = attention_ref(q, k, v, causal=causal,
                                       return_lse=True)
        before = flash_ops.KERNEL.launches
        got, lse = flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                                  return_lse=True)
        assert flash_ops.KERNEL.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        _assert_flash_close(got, want, q, k, v, causal)
        assert (lse - want_lse).abs().max().item() <= LSE_TOL


FAMILY_ARCHS = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "zamba2-1.2b",
                "xlstm-125m", "internvl2-76b", "musicgen-large",
                "qwen2.5-14b", "qwen2.5-32b", "granite-34b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch):
    """The smoke form of every family, f32 weights: prefill (kernel 7,
    f32, at head dim 16, once per attention call) and one decode step on
    the card equal the same model on the CPU (plain versions): logits and
    every cache leaf within f32's 2e-5 + 1e-5·|want| (MoE: 4e-3 +
    2^-8·|want|, its combine rounds to bf16, tests/_torch_families.py)."""
    from repro_torch.configs import get_model_config, reduce_for_smoke
    from repro_torch.models import api
    cfg = reduce_for_smoke(get_model_config(arch))
    params = api.init_params(cfg, torch.Generator().manual_seed(3), "cpu")

    def tree(t, fn):
        return {k: tree(v, fn) for k, v in t.items()} \
            if isinstance(t, dict) else fn(t)
    params = tree(params, lambda t: t.float())
    toks = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    atol, rtol = (4e-3, 2 ** -8) if cfg.family == "moe" else (2e-5, 1e-5)

    def close(got, want):
        excess = (got.cpu() - want).abs() - (atol + rtol * want.abs())
        assert excess.max().item() <= 0, excess.max().item()
    runs = {}
    for dev in ("cpu", cuda):
        p = tree(params, lambda t: t.to(dev))
        build.reset_launch_counts()
        logits, cache = api.prefill(cfg, p, {"tokens": toks.to(dev)},
                                    max_seq=65)
        nxt = logits.cpu().argmax(-1).to(torch.int32)[:, None]
        prefill_launches = build.launch_counts()["ss_flash_attention_fwd"]
        logits2, cache = api.decode_step(cfg, p, nxt.to(dev), 64, cache)
        runs[str(dev)] = (logits, logits2, cache, prefill_launches)
    (lc, lc2, cc, _), (lg, lg2, cg, n) = runs["cpu"], runs[str(cuda)]
    calls = (api.num_shared_attn(cfg) if cfg.family == "hybrid"
             else 0 if cfg.attention_free else cfg.num_layers)
    assert n == calls
    close(lg, lc)
    close(lg2, lc2)
    flat = lambda t, pre="": [x for k, v in t.items() for x in (  # noqa
        flat(v, pre + k) if isinstance(v, dict) else [(pre + k, v)])]
    for (name, g), (_, c) in zip(flat(cg), flat(cc)):
        close(g.float(), c.float())


def test_moe_ffn_on_the_card_is_deterministic(cuda):
    """The MoE combine adds each token's k terms in a fixed order (no
    atomics): two calls on the same input are bit-equal, at a capacity
    that drops tokens and at one that drops none."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduce_for_smoke
    from repro_torch.models import api, moe
    cfg = reduce_for_smoke(get_model_config("moonshot-v1-16b-a3b"))
    p = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(5),
                        cuda)["layers"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((4, 512, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6)
                    ).to(torch.bfloat16)
    for cf in (0.5, cfg.moe.num_experts / cfg.moe.top_k):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        a, aux_a = moe.moe_ffn(p, x, c)
        b, aux_b = moe.moe_ffn(p, x, c)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def _family_step_on_the_card(cuda, arch, impl, params, batch):
    from repro_torch.configs import get_model_config, reduce_for_smoke
    from repro_torch.configs.base import (OptimizerConfig, RunConfig,
                                          ShapeConfig)
    from repro_torch.train.steps import make_train_step
    cfg = reduce_for_smoke(get_model_config(arch))
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 256, 2, "train"),
                    optimizer=OptimizerConfig(lr=5e-3, warmup_steps=2))
    step, opt = make_train_step(run, attn_impl=impl)
    build.reset_launch_counts()
    out = step(params, opt.init(params), batch, 3)
    return out, build.launch_counts()["ss_flash_attention_fwd"]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-1.2b"])
def test_family_train_step_on_the_card_equals_plain_attention(cuda, arch):
    """A moe and a hybrid smoke model's train step on the card, f32: the
    step with kernel 7 (twice an attention call under remat "full", the
    hybrid's shared block once a call) against the same step with the plain
    "chunked" attention: the loss within 1e-5 relative and every
    parameter within 1e-5 + 1e-4 |p|, all but 2 % (Adam's sign of a
    gradient near zero; the MoE: a token routed otherwise); and the MoE's
    step, run twice from one state, bit-equal."""
    from repro_torch.configs import get_model_config, reduce_for_smoke
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    cfg = reduce_for_smoke(get_model_config(arch))
    params = tree_map(lambda t: t.float(), api.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(7), cuda))
    g = torch.Generator(device=cuda).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=g,
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (pf, _, mf), nf = _family_step_on_the_card(cuda, arch, "flash", params,
                                               batch)
    (pc, _, mc), nc = _family_step_on_the_card(cuda, arch, "chunked",
                                               params, batch)
    calls = api.num_shared_attn(cfg) if cfg.family == "hybrid" \
        else 2 * cfg.num_layers
    assert (nf, nc) == (calls, 0)
    assert abs(float(mf["loss"]) - float(mc["loss"])) <= \
        1e-5 * abs(float(mc["loss"]))
    for a, b in zip(tree_leaves(pf), tree_leaves(pc)):
        off = ((a - b).abs() > 1e-5 + 1e-4 * b.abs()).float().mean()
        assert off.item() <= 0.02
    if cfg.family == "moe":
        (again, _, _), _ = _family_step_on_the_card(cuda, arch, "flash",
                                                    params, batch)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                     tree_leaves(pf)))


# ------------------------------------------------------- the secure wire


def _mac2_chunked_plain(words, mk, rows=16384):
    """The plain tags of a large batch, a slab of rows at a time (the rows
    are independent; one slab's temporaries fit the card)."""
    return torch.cat([mac_tags_ref(
        words[i:i + rows], mk[i:i + rows, 0::2], mk[i:i + rows, 1::2],
        cwmac_ops.block_words(words.shape[1], words.shape[0]))
        for i in range(0, words.shape[0], rows)])


@pytest.mark.parametrize("B,n", [(70_000, 37), (70_000, 4096),
                                 (150_860, 4096)])
def test_cwmac_tags_over_65535_rows_equal_plain(cuda, B, n):
    """More rows than one grid's y extent: one launch per slab of MAX_ROWS
    (65,535) rows, each counted where it is launched, tags bit-equal to
    the plain version (a sealed llama3.2-1b checkpoint is ~150,860 rows of
    4,096 words)."""
    g = torch.Generator(device=cuda).manual_seed(B + n)
    words = torch.randint(-2 ** 31, 2 ** 31, (B, n), dtype=torch.int32,
                          device=cuda, generator=g)
    mk = torch.randint(0, 2 ** 31 - 1, (B, 4), dtype=torch.int32,
                       device=cuda, generator=g)
    before = cwmac_ops.KERNEL.launches
    got = cwmac_ops.mac2_batch(words, mk[:, 0], mk[:, 1], mk[:, 2], mk[:, 3])
    assert cwmac_ops.KERNEL.launches == before + -(-B // cwmac_ops.MAX_ROWS)
    assert torch.equal(got, _mac2_chunked_plain(words, mk))


def test_seal_many_over_65535_rows_opens_and_equals_plain(cuda):
    B, n = 70_000, 64
    t = lambda a: from_numpy(a, cuda)       # noqa: E731
    key, nonces, words = t(_u32(8, 40)), t(_u32((B, 3), 41)), \
        t(_u32((B, n), 42))
    ct, tags = aead.seal_many(key, nonces, words)
    ct_p, tags_p = aead.seal_many(key, nonces, words, backend="torch")
    assert torch.equal(ct, ct_p) and torch.equal(tags, tags_p)
    pt, ok = aead.open_many(key, nonces, ct, tags)
    assert torch.equal(pt, words) and bool(ok.all())


def test_sealed_checkpoint_on_the_card_equals_the_cpu_store(cuda, tmp_path,
                                                            monkeypatch):
    """The same salt gives the same sealed store from the card's seal and
    from the CPU's plain versions; the card restores it exactly."""
    import json
    import os

    from repro_torch.ckpt import checkpoint as ckpt
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(300, 1000, generator=g).to(torch.bfloat16),
              "b": torch.randn(4097, generator=g)}
    opt = {"m": [torch.randn(300, 1000, generator=g), None]}
    monkeypatch.setattr(os, "urandom", lambda k: bytes(range(k)))
    stores = {}
    for dev in ("cpu", cuda):
        tree = {k: v.to(dev) for k, v in params.items()}
        final = ckpt.save(str(tmp_path / str(dev)), 5, tree, opt,
                          device=dev)
        with open(os.path.join(final, "arrays.sealed"), "rb") as f:
            blob = f.read()
        with open(os.path.join(final, "manifest.json")) as f:
            aead_meta = json.load(f)["aead"]
        stores[str(dev)] = (blob, aead_meta)
    assert stores["cpu"] == stores[str(cuda)]
    _, p2, o2 = ckpt.restore(str(tmp_path / str(cuda)), params_like=params,
                             opt_like=opt, device=cuda)
    assert all(p2[k].device == cuda and torch.equal(p2[k].cpu(), params[k])
               for k in params)
    assert torch.equal(o2["m"][0].cpu(), opt["m"][0]) and o2["m"][1] is None


@pytest.mark.parametrize("sealed", [False, True])
def test_secure_exchange_and_keyed_route_at_8_workers_equal_the_cpu(cuda,
                                                                   sealed):
    from repro_torch.attest.directory import ephemeral_edge_key
    from repro_torch.core.router import route_keyed_sharded
    from repro_torch.dist.collectives import secure_exchange
    from repro_torch.dist.meshctx import make_mesh
    W = 8
    key = ephemeral_edge_key("shuffle", seed=0)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((W, W, 64, 16))
                         .astype(np.float32))
    rows = from_numpy(_u32((W, 4096, 16), 5), "cpu")
    rkeys = from_numpy(_u32((W, 4096), 6), "cpu")
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh((W,), ("model",), device=dev)
        kw = dict(key=key, step=3) if sealed else {}
        y = secure_exchange(x.to(dev), mesh, key=key, step=2)
        r = route_keyed_sharded(rows.to(dev), rkeys.to(dev), mesh, **kw)
        out[str(dev)] = [t.cpu() for t in (*y, *r)]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)
    assert bool(out["cpu"][1].all()) and bool(out["cpu"][4].all())
    assert int(out["cpu"][3].sum()) == W * 4096


@pytest.mark.parametrize("Dqk,Dv,B,H,Sq,Skv,causal", [
    (192, 128, 2, 16, 2048, 2048, True),      # latent attention's pair
    (192, 128, 1, 4, 130, 700, True),         # ragged, Sq < Skv
    (192, 128, 2, 4, 1000, 1000, False),
    (190, 120, 1, 4, 200, 200, True),         # padded to (192, 128)
    (96, 64, 1, 4, 200, 200, True),           # the (128, 128) one
])
def test_flash_kernel_takes_v_of_another_width(cuda, Dqk, Dv, B, H, Sq,
                                               Skv, causal):
    """Kernel 7 at (Dqk, Dv) pairs, latent attention's (192, 128) on the
    TMA + wgmma instantiation, against the plain version, in both
    layouts, its lse too."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=cuda).manual_seed(Dqk + Sq)
    q, k = (torch.randn((B, H, s, Dqk), generator=g, device=cuda)
            .bfloat16() for s in (Sq, Skv))
    v = torch.randn((B, H, Skv, Dv), generator=g, device=cuda).bfloat16()
    got, lse = flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                              return_lse=True)
    want, want_lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    assert got.shape == (B, H, Sq, Dv)
    _assert_flash_close(got, want, q, k, v, causal)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    bshd = flash_ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                     causal=causal)
    assert torch.equal(bshd.transpose(1, 2), got)


def test_dropless_moe_makes_no_host_sync(cuda):
    """Moonlight's MoE layer (smoke widths) on the card: no host sync
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one), the
    grouped products equal to a product per expert."""
    from repro_torch.configs import get_model_config, reduce_for_smoke
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import init_from_template
    cfg = reduce_for_smoke(get_model_config("moonlight-16b-a3b"))
    g = torch.Generator(device=cuda).manual_seed(5)
    p = init_from_template(MOE.moe_template(cfg), g, cuda)
    x = torch.randn((2, 64, cfg.d_model), generator=g,
                    device=cuda).bfloat16()
    want = MOE.moe_dropless(p, x, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = MOE.moe_dropless(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    rows = x.reshape(-1, cfg.d_model)[:40]
    ends = torch.tensor([5, 5, 17, 17, 30, 30, 31, 40], dtype=torch.int32,
                        device=cuda)
    grouped = MOE.grouped_mm(rows, p["wg"], ends)
    start = 0
    for e, end in enumerate(ends.tolist()):
        torch.testing.assert_close(grouped[start:end],
                                   rows[start:end] @ p["wg"][e])
        start = end
