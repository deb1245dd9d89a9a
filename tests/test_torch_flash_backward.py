"""Kernel 8's CPU-side contract (the card's checks are in
``tests/test_torch_gpu.py``): the plain backward it is held to, the
padded path, the wrapper's refusals, the dispatch rule of
``models/flash.py`` and the ``repro_torch::flash_attention_bwd``
operator the dry run counts on meta tensors."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import ops
from repro_torch.models import flash
from _torch_threads import one_torch_thread  # noqa: F401


def _bshd(shape_q, shape_kv, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(shape_q, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(shape_kv, generator=g).to(dtype) for _ in range(2))
    return q, k, v, do


def _autograd(q, k, v, do, causal, scale=None):
    """Autograd through the plain forward (top-left causal) in f64."""
    x = [t.double().requires_grad_() for t in (q, k, v)]
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", x[0], x[1]) * scale
    if causal:
        s = s.masked_fill(torch.ones(q.shape[1], k.shape[1],
                                     dtype=torch.bool).triu(1),
                          float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), x[2])
    return torch.autograd.grad(out, x, do.double())


@pytest.mark.parametrize("Sq,Skv,causal", [(70, 70, True), (70, 70, False),
                                           (40, 90, True), (90, 40, True),
                                           (33, 65, False)])
def test_plain_backward_equals_autograd(Sq, Skv, causal):
    """The plain backward the kernel is held to (``flash_backward_plain``,
    the CPU's) from the forward's out and lse equals autograd through the
    attention it differentiates: top-left causal, Sq below and above Skv
    (f32 against f64: within 2e-5)."""
    q, k, v, do = _bshd((2, Sq, 3, 16), (2, Skv, 3, 16), seed=Sq + Skv)
    out, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash.flash_backward_plain(q, k, v, out, lse, do, causal, Sq, Skv)
    for a, b, t in zip(got, _autograd(q, k, v, do, causal), (q, k, v)):
        assert a.shape == t.shape and a.dtype == t.dtype
        assert (a.double() - b).abs().max().item() <= 2e-5


def test_plain_backward_equals_the_block_recompute():
    """``flash_backward_plain`` over (16, 32) blocks, with the blocks above
    the causal diagonal skipped, equals it over one block in f32 on the
    same out and lse."""
    q, k, v, do = _bshd((2, 64, 2, 32), (2, 64, 2, 32), seed=4)
    out, lse = flash.flash_forward_plain(q, k, v, True, 16, 32)
    got = flash.flash_backward_plain(q, k, v, out, lse, do, True, 16, 32)
    want = flash.flash_backward_plain(q, k, v, out, lse, do, True, 64, 64)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("D,width", [(20, 24), (100, 104), (3, 8)])
def test_padded_backward_equals_the_plain_version(D, width, monkeypatch):
    """Where TMA cannot read rows of D columns, the card's wrapper hands
    kernel 8 zero-padded copies at the next multiple of 8 columns and the
    real D's scale, and slices the gradients: with a plain stand-in for
    the kernel's launches, that path gives the gradients at D."""
    def kernel(q, k, v, out, lse, do, causal, scale):
        assert q.shape[3] == width and all(
            t.is_contiguous() for t in (q, k, v, out, do))
        return tuple(g.to(q.dtype) for g in _autograd(q, k, v, do, causal,
                                                      scale))
    monkeypatch.setattr(ops, "_kernel_backward", kernel)
    q, k, v, do = _bshd((2, 50, 3, D), (2, 50, 3, D), seed=D)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    assert ops.padded_width(*(t.bfloat16() for t in (q, k, v))) == (width,
                                                                    width)
    got = ops._padded_backward(q, k, v, out, lse, do, True, width)
    want = _autograd(q, k, v, do, True)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert (a.double() - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("bad", ["dtype", "int", "out_shape", "do_dtype",
                                 "lse_shape", "lse_dtype", "lse_layout",
                                 "kv_shape", "device", "cpu"])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v, do = _bshd((1, 16, 2, 8), (1, 16, 2, 8), seed=1)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    if bad == "dtype":
        q, k, v, out, do = (t.half() for t in (q, k, v, out, do))
    elif bad == "int":
        q = q.to(torch.int32)
    elif bad == "out_shape":
        out = out[:, :8]
    elif bad == "do_dtype":
        do = do.double()
    elif bad == "lse_shape":
        lse = lse[:, :1]
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "lse_layout":       # (B, H, Sq) values, not contiguous
        lse = lse.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "kv_shape":
        v = v[:, :8]
    elif bad == "device":           # a mix of devices is refused, not moved
        do = do.to("meta")
    elif bad == "cpu":              # as the kernel takes them, on the CPU
        q, k, v, out, do = (t.bfloat16() for t in (q, k, v, out, do))
    with pytest.raises(ValueError):
        ops.flash_attention_backward(q, k, v, out, lse, do)


def test_backward_dispatch_rule():
    """``models/flash.py`` picks the backward from its input alone: plain
    on the CPU; on any other device kernel 8 for bf16 at D <= 128
    (padded D included), plain for f32 and above 128 (meta tensors stand
    in for the card's: the rule reads only the device type, dtype and
    D)."""
    def t(D, dtype=torch.bfloat16, device="meta"):
        return torch.empty((1, 4, 2, D), dtype=dtype, device=device)
    assert flash.backward_path(t(64, device="cpu")) == "plain"
    for D in (16, 20, 64, 112, 128):
        assert flash.backward_path(t(D)) == "kernel"
        assert ops.backward_takes(t(D))
    for x in (t(64, torch.float32), t(160), t(256), t(192, torch.float32)):
        assert flash.backward_path(x) == "plain"
        assert not ops.backward_takes(x)


def test_cpu_backward_is_plain_and_not_counted():
    """On the CPU the Function's backward is the block recompute and the
    card's plain-path counter does not move."""
    q, k, v, do = _bshd((1, 32, 2, 16), (1, 32, 2, 16), seed=2)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash.plain_backwards
    got = torch.autograd.grad(flash.flash_attention(*x, True, 16, 16), x, do)
    assert flash.plain_backwards == before
    out, lse = flash.flash_forward_plain(q, k, v, True, 16, 16)
    want = flash.flash_backward_plain(q, k, v, out, lse, do, True, 16, 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_backward_flops_count_the_causal_pairs():
    """Kernel 8's formula is five products of 2*D an attended pair, 2.5x
    the forward's, at the real D, top-left causal."""
    assert ops.backward_flops(1, 1, 4, 4, 8, True) == 10 * 8 * 10
    assert ops.backward_flops(2, 3, 6, 4, 96, True) == \
        10 * 96 * ops.attended_pairs(2, 3, 6, 4, True)
    for args in ((2, 3, 7, 7, 96, True), (1, 4, 5, 9, 64, False)):
        assert ops.backward_flops(*args) == 2.5 * ops.flops(*args)


@pytest.mark.parametrize("Sq,Skv,causal", [(7, 7, True), (5, 9, False)])
def test_backward_operator_on_meta_tensors(Sq, Skv, causal):
    """On meta tensors the backward is one ``repro_torch::
    flash_attention_bwd`` call: its fake gives dq, dk, dv of the inputs'
    shapes and type, launches nothing, and FlopCounterMode counts it by
    ``ops.backward_flops``."""
    q = torch.empty((2, Sq, 3, 96), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, Skv, 3, 96), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((2, 3, Sq), dtype=torch.float32, device="meta")
    with FlopCounterMode(display=False) as fc:
        dq, dk, dv = ops.flash_attention_backward(q, kv, kv, q, lse, q,
                                                  causal=causal)
    for g, t in ((dq, q), (dk, kv), (dv, kv)):
        assert g.device.type == "meta" and g.shape == t.shape
        assert g.dtype == torch.bfloat16
    assert fc.get_total_flops() == ops.backward_flops(2, 3, Sq, Skv, 96,
                                                      causal)
    counts = fc.get_flop_counts()["Global"]
    assert set(counts) == {torch.ops.repro_torch.flash_attention_bwd}


def test_function_backward_on_meta_goes_through_the_operator():
    """The training Function on meta bf16 tensors: kernel 7's operator
    forward, kernel 8's backward, 2 + 5 products of 2*D a causal pair;
    in f32 the backward is the plain one (matrix products, no operator),
    as on the card."""
    for dtype, op_in_bwd in ((torch.bfloat16, True), (torch.float32, False)):
        x = [torch.empty((2, 64, 4, 32), dtype=dtype, device="meta")
             .requires_grad_() for _ in range(3)]
        with FlopCounterMode(display=False) as fc:
            out = flash.flash_attention(*x, True, 32, 32)
            torch.autograd.grad(out, x, torch.empty_like(out))
        counts = fc.get_flop_counts()["Global"]
        fwd = ops.flops(2, 4, 64, 64, 32, True)
        assert counts[torch.ops.repro_torch.flash_attention_fwd] == fwd
        bwd = torch.ops.repro_torch.flash_attention_bwd
        assert (bwd in counts) == op_in_bwd
        if op_in_bwd:
            assert counts[bwd] == 2.5 * fwd
