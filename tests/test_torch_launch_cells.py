"""Every arch's smoke form through the port's dry run
(``repro_torch.launch.dryrun.run_cell``) in each shape kind on meta
tensors: the reference's record keys, no kernel launched and no plain
version called; and the command line."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.kernels import build
from repro_torch.launch import dryrun
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_traces_every_kind_on_meta(arch, tmp_path, monkeypatch):
    """Every shape kind of the arch's smoke form through ``run_cell``: the
    reference's record keys, no kernel launched (the launch counts stay
    as they were), no plain version called."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import flash

    def refuse(*a, **k):
        raise AssertionError("a meta trace reached a plain version")
    monkeypatch.setattr(ref, "attention_ref", refuse)
    monkeypatch.setattr(ops, "attention_ref", refuse)
    monkeypatch.setattr(flash, "flash_forward_plain", refuse)
    cfg = configs.reduce_for_smoke(configs.get_model_config(arch))
    before = build.launch_counts()
    for name, shape in SHAPES.items():
        small = type(shape)(name, 320, 2, shape.kind)   # >= 256 patches
        rec = dryrun.run_cell(arch, name, out_dir=str(tmp_path),
                              overrides=dict(model=cfg, shape=small))
        ok, _ = configs.cell_supported(arch, name)
        if not ok:
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert {"arch", "shape", "mesh", "timestamp", "lower_s",
                "compile_s", "nchips", "memory", "xla_cost", "roofline",
                "collective_count", "fits_one_card"} <= set(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes",
                                      "peak_estimate_bytes"}
        assert set(rec["roofline"]) == {
            "t_compute_s", "t_mem_s", "t_coll_s", "dominant",
            "hlo_flops_per_chip", "hlo_bytes_per_chip",
            "collective_bytes_per_chip", "collective_by_kind",
            "model_flops_per_chip", "useful_flops_ratio",
            "roofline_fraction"}
        assert rec["mesh"] == "h100x1" and rec["nchips"] == 1
        assert rec["compile_s"] is None and rec["xla_cost"] is None
        assert rec["roofline"]["t_coll_s"] == 0 and rec["fits_one_card"]
        assert rec["roofline"]["hlo_flops_per_chip"] > 0
        with open(tmp_path / f"{arch}__{name}__h100x1.json") as f:
            assert json.load(f)["status"] == "ok"
    assert build.launch_counts() == before


def test_command_line_writes_a_record_a_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "xlstm-125m" in out.stdout and " ok " in out.stdout
    rec = json.loads((tmp_path / "xlstm-125m__long_500k__h100x1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["fits_one_card"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "SKIP" in out.stdout
