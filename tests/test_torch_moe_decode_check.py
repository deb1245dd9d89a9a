"""``chip_smoke.py``'s MoE decode check on the CPU, at the smoke form of
kimi-k2: decode at S against prefill(S + steps), one layer at a time, on
a copy of the config whose capacity drops nothing.  Where that copy's
expert buffer over the whole prefill would not fit (kimi-k2 at full
width: 45 GB), the prefill side's FFN runs a chunk of the sequence at a
time; with nothing dropped, every token's update is the one the whole
call gives it, so the check's numbers are the same at any chunk."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_model_config
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.models import api

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 2, 96, 3


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_model_config("kimi-k2-1t-a32b"))
    g = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, g, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S + STEPS), generator=g,
                           dtype=torch.int32)
    moe = cfg.moe
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    return cfg, nodrop, params, tokens


@pytest.mark.parametrize("chunk", [40, STEPS])
def test_chunked_no_drop_update_equals_the_whole(smoke, model, chunk):
    _, nodrop, params, tokens = model
    whole = smoke.decode_layerwise(torch, nodrop, params, tokens, None,
                                   STEPS)
    got = smoke.decode_layerwise(torch, nodrop, params, tokens, None, STEPS,
                                 chunk)
    assert got == whole
    err, alike, pairs = whole
    assert pairs == B * nodrop.num_layers * STEPS and alike == pairs
    assert 0 < err <= smoke.LAYER_ATTN_RTOL


def test_a_chunk_holds_every_decoded_position(smoke, model):
    _, nodrop, params, tokens = model
    with pytest.raises(AssertionError):
        smoke.decode_layerwise(torch, nodrop, params, tokens, None, STEPS,
                               STEPS - 1)


def test_no_drop_chunk_fits_the_buffer(smoke):
    """kimi-k2 at full width and the served 4 requests takes a chunk of
    the sequence; moonshot's whole prefill fits, so its check is the one
    over every token."""
    kimi = get_model_config("kimi-k2-1t-a32b")
    moonshot = get_model_config("moonshot-v1-16b-a3b")
    chunk = smoke.nodrop_chunk(kimi, 4, 2048 + 16)
    assert 16 <= chunk < 2048
    assert kimi.moe.num_experts * 4 * chunk * kimi.d_model * 2 <= \
        smoke.NODROP_BUFFER_BYTES
    assert smoke.nodrop_chunk(moonshot, 4, 2049) == 2049
