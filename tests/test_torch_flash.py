"""The torch port's flash-attention op on the CPU (its plain version,
``kernels/flash_attention/ref.py``) against the JAX reference's Pallas
kernel ``flash_attention_bhsd`` run in interpret mode (jitted), and its
wrapper's refusals.  The same inputs, made with numpy from a seed, go to
both.  Tolerances are those of ``tests/test_kernels.py`` for the
reference's kernel: max-abs 2e-5 in f32 (the algorithm: exact softmax
attention, f32 sums in another order), 3e-2 in bf16 (the working type:
outputs round to bf16, whose ulp at magnitude 2..4 is 1.6e-2), and in
bf16 also the bound that scales with the values
(``ref.bf16_mismatch``: 2^-7 of each output plus 2^-8 of P|V|, and a
row's relative L2 error within 1e-2), which a max-abs bound of 3e-2 is
not where the outputs are ~0.03.  The CUDA
kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 9)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention import ref as j_ref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd as j_flash_bhsd
from repro_torch.kernels.flash_attention import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jnp and torch arrays of ``dtype`` (bf16 rounds
    to nearest even on both sides)."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _bf16_within(got, want, q, k, v, causal):
    _, excess, row_rel = ref.bf16_mismatch(
        got, torch.from_numpy(np.asarray(want, np.float32)), q, k, v,
        causal=causal)
    return excess <= 0 and row_rel <= ref.BF16_ROW_RTOL


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,qc,kc", [(128, 64, 64), (256, 64, 32)])
def test_flash_bhsd_equals_reference_kernel(dtype, causal, S, qc, kc):
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 3, S, 64), (2, 3, S, 64),
                                         seed=S + qc + kc), dtype)
    want = j_flash_bhsd(jq, jk, jv, causal=causal, q_chunk=qc, kv_chunk=kc,
                        interpret=True)
    got = ops.flash_attention_bhsd(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _err(got, want) <= TOL[dtype]
    if dtype == "bfloat16":
        assert _bf16_within(got, want, q, k, v, causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_short_queries_are_top_left_aligned(dtype):
    """Sq < Skv: the TPU kernel masks top-left (row i sees keys 0..i), and
    so does the port; the reference's ``ref.py`` masks bottom-right
    (``tril(k=Skv-Sq)``) and disagrees, which the port does not copy."""
    (jq, jk, jv), (q, k, v) = _both(_qkv((1, 2, 64, 64), (1, 2, 192, 64),
                                         seed=11), dtype)
    want = j_flash_bhsd(jq, jk, jv, causal=True, q_chunk=32, kv_chunk=64,
                        interpret=True)
    got = ops.flash_attention_bhsd(q, k, v, causal=True)
    assert _err(got, want) <= TOL[dtype]
    if dtype == "bfloat16":
        assert _bf16_within(got, want, q, k, v, True)
    assert _err(got, j_ref.attention_ref(jq, jk, jv, causal=True)) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_model_layout_equals_reference_op(dtype):
    """The (B, S, H, D) entry the model calls, against the reference's
    ``ops.flash_attention`` (interpret mode on the CPU)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 128, 4, 64), (2, 128, 4, 64),
                                         seed=5), dtype)
    want = j_ops.flash_attention(jq, jk, jv, causal=True, q_chunk=64,
                                 kv_chunk=64)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.shape == q.shape
    assert _err(got, want) <= TOL[dtype]


def test_bf16_bound_rejects_a_dropped_kv_tile():
    """A causal result whose last 64 query rows leave out their diagonal
    KV tile (a kernel that skips its last tile) fails the scaled bf16
    bound, which the exact result meets."""
    S = 4096
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 4, S, 64), (1, 4, S, 64), seed=8))
    want = ref.attention_ref(q, k, v)
    dropped = want.clone()
    dropped[:, :, -64:] = ref.attention_ref(
        q[:, :, -64:], k[:, :, :-64], v[:, :, :-64], causal=False)
    _, excess, row_rel = ref.bf16_mismatch(want, want, q, k, v)
    assert excess <= 0 and row_rel == 0
    _, excess, row_rel = ref.bf16_mismatch(dropped, want, q, k, v)
    assert excess > 0 and row_rel > ref.BF16_ROW_RTOL


def test_flash_plain_version_takes_any_length():
    """The reference needs S to be a multiple of its chunk; the port (and
    its kernel, which masks its ragged tail) takes any S: a ragged S
    equals the first rows of a longer causal run."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 128, 64),
                                                  (1, 2, 128, 64), seed=3))
    full = ops.flash_attention_bhsd(q, k, v)
    part = ops.flash_attention_bhsd(q[:, :, :77], k[:, :, :77], v[:, :, :77])
    assert torch.allclose(part, full[:, :, :77], atol=2e-6, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "int", "rank", "device", "shape",
                                 "empty_kv"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 64, 64),
                                                  (1, 2, 64, 64), seed=1))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "int":
        q = q.to(torch.int32)
    elif bad == "rank":
        q = q[0]
    elif bad == "device":          # a mix of devices is refused, not moved
        k = k.to("meta")
    elif bad == "shape":
        v = v[:, :1]
    elif bad == "empty_kv":
        k, v = k[:, :, :0], v[:, :, :0]
    with pytest.raises(ValueError):
        ops.flash_attention_bhsd(q, k, v)


def test_kernel_head_dims_cover_every_config():
    """Kernel 7 takes every head dim 1 <= D <= 256 (its TMA kernel up to
    128, its wide kernel above), which holds every head dim that a config
    or its ``reduce_for_smoke`` form gives attention (xlstm-125m's 192 is
    attention-free) and the tests' D = 32; D = 0 and D > 256 raise on the
    card's path, naming the limit."""
    from repro_torch import configs
    assert (ops.TMA_HEAD_DIM, ops.MAX_HEAD_DIM) == (128, 256)
    need = {32}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_model_config(arch)
        if not cfg.attention_free:
            need |= {cfg.head_dim,
                     configs.reduce_for_smoke(cfg).head_dim}
    assert need == {16, 32, 64, 112, 128}
    for D in sorted(need) + [1, 8, 20, 96, 100, 120, 129, 160, 192, 256]:
        ops._check_head_dim(D)
    for D in (0, 257, 320):
        with pytest.raises(ValueError, match=r"1 <= D <= 256"):
            ops._check_head_dim(D)


def test_flash_flops_count_the_causal_pairs():
    """The operator's FLOP formula (what the dry run counts on meta
    tensors) is 4 * D * the attended pairs, top-left causal."""
    assert ops.attended_pairs(1, 1, 4, 4, True) == 10
    assert ops.attended_pairs(1, 1, 6, 4, True) == 10 + 2 * 4
    assert ops.attended_pairs(2, 3, 4, 5, False) == 2 * 3 * 20
    assert ops.flops(2, 3, 4, 4, 96, True) == 4 * 96 * 2 * 3 * 10
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty((2, 7, 3, 96), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc:
        out, lse = ops.flash_attention(q, q, q, return_lse=True)
        out2 = ops.flash_attention_bhsd(q.transpose(1, 2), q.transpose(1, 2),
                                        q.transpose(1, 2), causal=False)
    assert out.device.type == "meta" and out.shape == q.shape
    assert lse.shape == (2, 3, 7) and lse.dtype == torch.float32
    assert out2.shape == (2, 3, 7, 96)
    assert fc.get_total_flops() == ops.flops(2, 3, 7, 7, 96, True) + \
        ops.flops(2, 3, 7, 7, 96, False)


@pytest.mark.parametrize("dtype,D,width", [(torch.bfloat16, 20, 24),
                                           (torch.bfloat16, 100, 104),
                                           (torch.float32, 18, 20)])
def test_padded_head_dim_equals_the_plain_version(dtype, D, width):
    """Where TMA cannot read the tensors (rows that are not 16-byte
    multiples), the card's wrapper hands its kernel zero-padded copies at
    the next width of 16 bytes and the real D's scale, and slices the
    output: the same path run with the plain version gives the plain
    version's output and lse at D (f32 sums in another order: within
    1e-6; the bf16 output rounds once either way, so within one ulp)."""
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn((2, 3, 70, D), generator=g).to(dtype)
               for _ in range(3))
    assert ops.padded_width(q, k, v) == (width, width)
    assert ops.padded_width(*(t.new_zeros((1, 1, 8, width))
                              for t in (q, k, v))) is None
    for causal in (True, False):
        got, lse = ops._padded(ops._plain, q, k, v, causal, 2, 1, True,
                               (width, width))
        want, want_lse = ops._plain(q, k, v, causal, 2, 1, True)
        assert got.shape == q.shape and got.is_contiguous()
        assert (lse - want_lse).abs().max().item() <= 1e-6
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7
        assert ((got.float() - want.float()).abs()
                - tol * want.float().abs().clamp_min(1)).max().item() <= 0
