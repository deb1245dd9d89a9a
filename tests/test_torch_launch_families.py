"""The dry run's train records of the families beyond the dense one, at
their ``reduce_for_smoke`` forms and the cut shapes ``chip_smoke.py``
phase 16 gives them (a replaced model, shape and remat through
``run_cell``'s overrides), against the formulas phase 16 holds them to on
the card: the weight products (``aten.mm``) at remat "none" equal
``chip_smoke._mm_flops_formula``, and kernel 7's FLOPs, at "none" and at
the step's remat, equal its calls (``chip_smoke._attn_calls``) times
``chip_smoke.flash_flops``, exactly (counts, no tolerance): under remat
"full" kernel 7 runs twice a layer, and the hybrid's shared block,
outside the remat, once a call."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,layers,remat", [
    ("zamba2-1.2b", None, "full"), ("zamba2-1.2b", 13, "full"),
    ("xlstm-125m", None, "none"), ("moonshot-v1-16b-a3b", 1, "full"),
    ("musicgen-large", None, "full"), ("internvl2-76b", None, "full")])
def test_family_train_records_equal_their_formulas(smoke, tmp_path, arch,
                                                   layers, remat):
    cfg = reduce_for_smoke(get_model_config(arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, S = 2, 64 if cfg.frontend != "vision_patches" else 512  # 256 patches
    shape = ShapeConfig("train_4k-cut", S, B, "train")
    rec = dryrun.run_cell(arch, "train_4k", out_dir=str(tmp_path),
                          force=True, overrides=dict(model=cfg, shape=shape,
                                                     remat=remat))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["run_shape"] == {"seq_len": S, "global_batch": B,
                                "kind": "train"}
    ff = smoke.flash_flops(B, cfg.num_heads, S, S, cfg.head_dim, True)
    k7 = "repro_torch.flash_attention_fwd"
    run = dryrun.get_run_config(arch, "train_4k", model=cfg)
    none = dryrun.trace_cell(dataclasses.replace(run, shape=shape,
                                                 remat="none"))[0]
    assert none.flops_by_op["aten.mm"] == smoke._mm_flops_formula(cfg, B, S)
    for r, got in ((remat, rec["flops_by_op"]), ("none", none.flops_by_op)):
        assert got.get(k7, 0) == smoke._attn_calls(cfg, r) * ff
