"""The FLOP and byte formulas against counts by hand, the metric readers
on a made-up run, the trace's arithmetic, the traffic's mix."""
import itertools
import math
from types import SimpleNamespace

import pytest

from portbench.lib import peaks, runner, spec
from portbench.lib.trace import Trace

BENCH = spec.benchmark()
GRANITE = spec.model(spec.load_config(BENCH, "granite-34b"))
MUSICGEN = spec.model(spec.load_config(BENCH, "musicgen-selfattn-2.4b"))


def test_weights_by_hand():
    d, f, L = 6144, 24576, 88
    per_layer = 2 * d * d + 2 * d * 128 + 2 * d * f
    w = spec.matmul_weights(GRANITE)
    assert w == {"layers": L * per_layer, "lm_head": d * 49152,
                 "frontend": 0}
    total = sum(math.prod(x.shape) for x in spec.layout(GRANITE))
    assert total == L * (per_layer + 2 * d) + 2 * d * 49152 + d
    assert total == 33_962_366_976          # 67.9 GB of bf16
    m = spec.matmul_weights(MUSICGEN)
    assert m["layers"] == 48 * (4 * 2048 * 2048 + 2 * 2048 * 8192)
    assert m["frontend"] == 128 * 2048


def test_attention_by_hand():
    # 4 keys attended by row 3, 1 by row 0: 10 pairs a head
    assert spec.attended_pairs(1, 1, 4) == 10
    assert spec.attention_flops(GRANITE, 2, 4) == 88 * 4 * 128 * 2 * 48 * 10
    # q and o of 48 heads, k and v of one, bf16
    assert spec.attention_bytes(GRANITE, 1, 8, lse=False) \
        == 2 * 8 * 128 * (2 * 48 + 2)
    assert spec.attention_bytes(MUSICGEN, 1, 8, lse=True) \
        == 2 * 8 * 64 * 128 + 4 * 32 * 8


def test_prefill_mfu_reader():
    read = runner.load_metric("mfu.prefill")
    B, S = 4, 2048
    w = spec.matmul_weights(GRANITE)
    flops = 2 * w["layers"] * B * S + 88 * 4 * 128 * B * 48 * S * (S + 1) \
        // 2 + 2 * w["lm_head"] * B
    r = SimpleNamespace(model=GRANITE, work=[(B, S)] * 3, window_s=3.0,
                        peaks=peaks)
    assert read(r) == pytest.approx(100 * flops / peaks.BF16_FLOPS)


def test_train_mfu_reader():
    read = runner.load_metric("mfu.train")
    B, S = 3, 2048
    w = spec.matmul_weights(MUSICGEN)
    T = B * S
    flops = 6 * T * (w["layers"] + w["lm_head"]) + 4 * T * 128 * 2048 \
        + 3 * 48 * 4 * 64 * B * 32 * S * (S + 1) // 2
    r = SimpleNamespace(model=MUSICGEN, work=[(B, S)] * 2, window_s=1.0,
                        peaks=peaks)
    assert read(r) == pytest.approx(200 * flops / peaks.BF16_FLOPS)


class Event:
    def __init__(self, name, start, dur, device=False, kind="kernel"):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._kind = device, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def activity_type(self):
        return self._kind


def made_trace():
    card = [
        Event("marker", 0, 10, device=True),
        Event("gemm", 100, 300, device=True),
        Event("flash_fwd_bf16_kernel<128>", 300, 200, device=True),
        Event("Memcpy DtoH", 900, 50, device=True, kind="gpu_memcpy"),
        Event("marker", 990, 10, device=True),
    ]
    both = [
        Event("portbench.window", 0, 1000),
        Event("portbench.prefill", 0, 600),
        Event("aten::mm", 100, 50),
        Event("portbench.seal_open", 600, 400),
        Event("gemm", 100, 300, device=True),
        Event("portbench.window", 0, 1000, device=True,
              kind="gpu_user_annotation"),
        Event("late", 990, 100, device=True),
    ]
    return Trace(card, both)


def test_trace_union_and_gaps():
    t = made_trace()
    assert t.window_s == pytest.approx(1e-6)
    # 0-10, 100-500, 900-950 and 990-1000: overlapping kernels count once
    assert t.busy_s == pytest.approx(470e-9)
    assert t.device_s("flash|fmha|attention") == pytest.approx(200e-9)
    # the pass with the host: 100-400 and 990-1000 (clipped) busy; the
    # annotation's own range on the device is no work
    gaps = t.idle_gaps(10)
    assert [g[1] for g in gaps] == pytest.approx([590e-9, 100e-9])
    assert gaps[0][0].startswith("portbench.prefill")
    assert gaps[1][0] == "portbench.prefill / no host op"
    assert t.top_ops(1)[0][0] == "gemm"


def test_device_metrics_read_the_trace():
    r = SimpleNamespace(model=GRANITE, trace=made_trace(), traffic={},
                        traced_work=[(1, 8)], spans={"seal_open": [0.002]},
                        peaks=peaks)
    assert runner.load_metric("device_idle.prefill")(r) == pytest.approx(53)
    assert runner.load_metric("seal_open_ms.prefill")(r) == pytest.approx(2)
    least = 88 * peaks.least_seconds(4 * 128 * 48 * 36,
                                     spec.attention_bytes(GRANITE, 1, 8,
                                                          False))
    assert runner.load_metric("attn_roofline.prefill")(r) \
        == pytest.approx(100 * least / 200e-9)
    r.trace = None
    assert runner.load_metric("attn_roofline.prefill")(r) is None


def kernel_trace(kernels):
    """A trace whose card ran ``kernels`` = [(name, start, duration)]."""
    card = [Event(n, s, d, device=True) for n, s, d in kernels]
    both = [Event("portbench.window", 0, 10_000)] + card
    return Trace(card, both)


def test_train_attention_roofline_counts_a_backward_kernel_it_matches():
    read = runner.load_metric("attn_roofline.train")
    mod = read.__globals__
    B, S, m = 3, 2048, MUSICGEN
    fwd = mod["least_seconds"](m, B, S)
    bwd = mod["least_backward_seconds"](m, B, S)
    # by hand: 2.5 x the forward's FLOPs; q, k, v, o, do, lse read and
    # dq, dk, dv written, bf16 but the f32 lse
    H, K, D = 32, 32, 64
    nbytes = 2 * B * S * D * (4 * H + 4 * K) + 4 * B * H * S
    assert bwd == pytest.approx(48 * peaks.least_seconds(
        2.5 * 4 * D * spec.attended_pairs(B, H, S), nbytes))
    r = SimpleNamespace(model=m, traffic={"remat": "full"},
                        traced_work=[(B, S)] * 2)
    r.trace = kernel_trace([("flash_fwd_kernel<64>", 0, 1000)])
    assert read(r) == pytest.approx(100 * 2 * 2 * fwd / 1e-6)
    # a backward kernel that matches the pattern adds its time below and
    # its least time above, so a faster backward reads higher
    for name in ("flash_bwd_kernel<64>", "FlashAttentionBackward"):
        r.trace = kernel_trace([("flash_fwd_kernel<64>", 0, 1000),
                                (name, 2000, 3000)])
        assert read(r) == pytest.approx(100 * (2 * 2 * fwd + 2 * bwd)
                                        / 4e-6)
    r.trace = kernel_trace([("sm80_xmma_gemm_f32f32", 0, 1000)])
    assert read(r) is None


def test_every_seed_runs_the_same_mix():
    tr = spec.load_traffic("granite-34b.sealed-prefill")["traffic"]
    cycle = sum(tr["seq_counts"])
    for seed in (1, 2**31 + 7):
        order = list(itertools.islice(spec.batch_order(tr, seed), 3 * cycle))
        for c in range(3):
            part = order[c * cycle:(c + 1) * cycle]
            assert [part.count(s) for s in tr["seq_lens"]] == tr["seq_counts"]
    assert list(itertools.islice(spec.batch_order(tr, 5), 40)) != \
        list(itertools.islice(spec.batch_order(tr, 6), 40))


def test_sample_holds_a_longest_request_and_keeps_its_budget():
    done = [(0, 0, 8192)] + [(i, r, 1024) for i in range(1, 5)
                             for r in range(8)]
    sample = spec.sample_requests(done, 3, 8192)
    assert sample[0] == (0, 0, 8192)
    assert sum(s for _, _, s in sample[1:]) == 8192
