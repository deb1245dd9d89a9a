"""A configuration of another family joins the benchmark with new files
and entries only: a copy of ``portbench/`` takes a tiny configuration of
the port's ``moe`` family (``moe_family/``: its configuration naming its
own family module, that module, one prefill cell), and a run of the cell
on the CPU comes out correct, its FLOPs those of the active weights,
and with the program's logits altered, not correct.  Nothing of the
repository's ``portbench/`` is touched."""
import hashlib
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench.lib import peaks, port, runner, spec

FIXTURE = Path(__file__).resolve().parent / "moe_family"
CELL = "tiny-moe.sealed-prefill"
#: a cell whose metrics the new prefill cell reports too
LIKE = "granite-34b.sealed-prefill"


def digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """BENCHMARK.json and ``portbench/`` copied under ``tmp_path``, the
    fixture's files added (none replaces one) and its entries appended."""
    repo_bench, before = spec.BENCH, digest(spec.BENCH)
    tree = tmp_path / "portbench"
    shutil.copytree(repo_bench, tree,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in FIXTURE.rglob("*"):
        rel = src.relative_to(FIXTURE)
        if src.is_file() and "__pycache__" not in rel.parts \
                and src.name != "entries.json":
            assert not (tree / rel).exists()
            (tree / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, tree / rel)
    data = spec.benchmark()
    entries = json.loads((FIXTURE / "entries.json").read_text())
    data["configs"] += entries["configs"]
    data["workloads"] += entries["workloads"]
    for e in data["end_to_end"] + data["per_layer"]:
        if LIKE in e.get("workloads", []):
            e["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "BENCH", tree)
    yield spec.benchmark()
    assert digest(repo_bench) == before


def run(bench, seed=2**31 + 29):
    return runner.run_cell(bench, CELL, seed=seed, seconds=0.3, trace=False,
                           device="cpu", t_start=time.perf_counter())


def test_a_new_family_runs_correct_from_new_files(bench):
    res = run(bench)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"ttft_p95_ms", "prompt_tokens_per_s",
                                   "setup_s"}


def test_its_flops_count_the_active_weights(bench):
    m = spec.model(spec.load_config(bench, "tiny-moe"))
    assert spec.family(m).__file__ == str(spec.BENCH / "reference"
                                          / "plain_moe.py")
    d, L, V, B, S = 64, 2, 256, 4, 16
    attn = d * 64 + 2 * d * 32 + 64 * d          # wq, wk and wv, wo
    active = attn + d * 4 + 2 * 3 * d * 32       # router, 2 of 4 experts
    every = attn + d * 4 + 4 * 3 * d * 32
    pairs = B * 4 * S * (S + 1) // 2
    by_hand = 2 * L * active * B * S + L * 4 * 16 * pairs + 2 * d * V * B
    read = runner.load_metric("mfu.prefill")
    assert read.__globals__["flops"](m, B, S) == by_hand
    assert spec.matmul_weights(m)["layers"] == L * active < L * every
    r = SimpleNamespace(model=m, work=[(B, S)] * 2, window_s=1.0,
                        peaks=peaks)
    assert read(r) == pytest.approx(200 * by_hand / peaks.BF16_FLOPS)


def test_logits_altered_where_produced_are_not_correct(bench, monkeypatch):
    from repro_torch.models import api
    real = api.prefill

    def altered(*a, **kw):
        logits, cache = real(*a, **kw)
        logits = logits.clone()
        best = logits.argmax(dim=-1)
        logits[torch.arange(len(best)), best] -= 100.0   # another token wins
        return logits, cache
    monkeypatch.setattr(api, "prefill", altered)
    res = run(bench)
    assert not res["correct"]
    assert res["checks"]["logits_rel_l2"]["value"] > \
        10 * res["checks"]["logits_rel_l2"]["limit"]


def test_a_key_the_port_lacks_raises(bench):
    m = spec.model(spec.load_config(bench, "tiny-moe"))
    port.model_config("tiny-moe", m)
    m["moe"] = dict(m["moe"], num_expert=4)
    with pytest.raises(KeyError, match="num_expert"):
        port.model_config("tiny-moe", m)


def test_a_kind_without_a_driver_lists_the_kinds():
    assert {"prefill", "train"} <= set(runner.kinds())
    with pytest.raises(ValueError, match="the kinds are"):
        runner.driver("decode")


def test_the_family_is_named_only_on_a_model(bench):
    m = spec.model(spec.load_config(bench, "tiny-moe"))
    assert spec.family(m) is spec.load("reference", "plain_moe")
    with pytest.raises(TypeError, match="Model"):
        spec.matmul_weights(dict(m))
