"""``chip_smoke.py`` phase 17's serving plans on the CPU: the four configs
that had never run on the card (qwen2.5-32b, granite-34b, internvl2-76b,
kimi-k2) at full width and the served shape (4 requests x 2,048 tokens,
+32 decoded), each at the largest depth whose dry-run prefill and decode
peak estimates are both within ``SERVE_PEAK_LIMIT`` (72e9 bytes).  The
depths and the estimates are counts on meta tensors, pinned here so that
a change to the model, the analyzer or the plan that moves them shows
before a card run does."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_model_config

ROOT = Path(__file__).resolve().parent.parent

#: arch -> (depth, prefill estimate, decode estimate), bytes
PLANS = {
    "qwen2.5-32b": (64, 70_846_171_136, 67_778_500_640),
    "granite-34b": (88, 70_814_650_368, 68_305_704_992),
    "internvl2-76b": (36, 70_600_024_064, 67_159_719_968),
    "kimi-k2-1t-a32b": (1, 49_422_713_860, 38_963_236_660),
}


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DRYRUN_DIR = tmp_path_factory.mktemp("dryrun")
    return mod


def test_the_plan_serves_the_four_configs_that_never_ran(smoke):
    assert smoke.FULL_SERVE == tuple(PLANS)
    assert smoke.FULL_SERVE_SHAPE[:3] == (4, 2048, 32)


@pytest.mark.parametrize("arch", list(PLANS))
def test_serve_plan_depth_and_estimates(smoke, arch):
    depth, prefill, decode = PLANS[arch]
    L, pre, dec, _ = smoke.serve_plan(arch)
    assert L == depth
    assert pre["run_shape"] == {"seq_len": 2048, "global_batch": 4,
                                "kind": "prefill"}
    assert dec["run_shape"] == {"seq_len": 2080, "global_batch": 4,
                                "kind": "decode"}
    assert pre["memory"]["peak_estimate_bytes"] == prefill
    assert dec["memory"]["peak_estimate_bytes"] == decode
    assert max(prefill, decode) <= smoke.SERVE_PEAK_LIMIT
    # the largest such depth: one layer more is over the limit
    cfg = get_model_config(arch)
    if depth < cfg.num_layers:
        more = dataclasses.replace(cfg, num_layers=depth + 1)
        peaks = [smoke._dryrun_shape(arch, shape, S, 4, kind, more)[
            "memory"]["peak_estimate_bytes"] for shape, S, kind in (
                ("prefill_32k", 2048, "prefill"),
                ("decode_32k", 2080, "decode"))]
        assert max(peaks) > smoke.SERVE_PEAK_LIMIT


@pytest.mark.parametrize("limit,full", [(36, 80), (1, 61), (64, 64),
                                        (0, 61), (47, 48), (5, 5)])
def test_largest_depth_of_a_monotone_limit(smoke, limit, full):
    calls = []

    def fits(L):
        assert 1 <= L <= full
        calls.append(L)
        return L <= limit
    assert smoke._largest_depth(fits, full) == limit
    assert len(calls) <= 2 * full.bit_length() + 1
