"""``chip_smoke.py`` phase 17's train plans on the CPU: internvl2-76b's
step (4 x 2,048 with 256 patches, AdamW, remat "full") at the largest
depth whose dry-run peak estimate is within ``TRAIN_PEAK_LIMIT`` (72e9
bytes), its batch halved while no depth fits; and kimi-k2's step, which
at one layer x 1 x 2,048 does not fit one card.  Counts on meta tensors,
pinned."""
import importlib.util
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DRYRUN_DIR = tmp_path_factory.mktemp("dryrun")
    return mod


def test_vlm_train_plan_is_one_layer_at_batch_four(smoke):
    B, L, rec, none_flops, _ = smoke.vlm_train_plan()
    assert (B, L) == (4, 1)
    assert rec["run_shape"] == {"seq_len": 2048, "global_batch": 4,
                                "kind": "train"}
    assert rec["memory"]["peak_estimate_bytes"] == 66_271_116_328
    assert rec["memory"]["peak_estimate_bytes"] <= smoke.TRAIN_PEAK_LIMIT
    # the step's weight products with the vision term, exactly
    run = smoke._family_run(smoke.VLM_ARCH, B, 2048, L, "full")
    assert none_flops["aten.mm"] == smoke._mm_flops_formula(run.model, B,
                                                            2048)
    # two layers are over the limit at this batch
    two = smoke._train_record(smoke.VLM_ARCH, smoke._family_run(
        smoke.VLM_ARCH, B, 2048, 2, "full"))
    assert two["memory"]["peak_estimate_bytes"] > smoke.TRAIN_PEAK_LIMIT


def test_kimi_train_plan_does_not_fit_one_card(smoke):
    got = smoke.kimi_train_plan()
    assert (got["layers"], got["batch"], got["seq"]) == (1, 1, 2048)
    assert got["optimizer"] == "adafactor"
    assert got["peak_estimate_gb"] == pytest.approx(321.904129056)
    assert got["trains_on_one_card"] is False
    assert got["peak_estimate_gb"] * 1e9 > dryrun.HBM_BYTES
