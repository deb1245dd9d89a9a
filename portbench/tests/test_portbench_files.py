"""BENCHMARK.json and the files it names: they parse, keep the contract's
shape, and every metric is reported by the cells it lists."""
import json
import re

import pytest

from portbench.lib import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in metrics + BENCH["configs"]
             + BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len({e["name"] for e in metrics}) == len(metrics)
    for e in metrics:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse(cell):
    entry = spec.cell_entry(BENCH, cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    tr = spec.load_traffic(cell)
    assert tr["kind"] in runner.kinds()
    cfg = spec.load_config(BENCH, entry["config"])
    m = spec.model(cfg)
    assert m["num_heads"] % m["num_kv_heads"] == 0
    assert set(cfg["reduced"]) <= set(cfg)
    if tr["kind"] == "prefill":
        t = tr["traffic"]
        assert all(t["tokens_per_batch"] % s == 0 for s in t["seq_lens"])
        assert t["loop"] == "closed" and t["clients"] == 1
    assert all(v > 0 for v in tr["limits"].values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_metric_of_a_cell_names_an_end_to_end_metric_it_reports(cell):
    tr = spec.load_traffic(cell)
    e2e = runner.driver(tr["kind"]).END_TO_END
    ends, layers = runner.cell_metrics(BENCH, cell,
                                       dict.fromkeys(e2e + ("setup_s",)))
    reported = {e["name"] for e in ends}
    assert "setup_s" in reported and len(reported) >= 2 and layers
    for e in layers:
        assert e["moves"] in reported
        assert (spec.BENCH / "metrics" / f"{e['name']}.py").exists()


def test_layers_and_workload_lists():
    cells = {w["name"] for w in BENCH["workloads"]}
    for e in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(e.get("workloads", cells)) <= cells
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
