"""One run of one cell: its files found by name, its driver run, its
metrics read, its result line built.

The cell's traffic file names its driver (``kind``: the module
``portbench/lib/<kind>.py``, whose ``drive`` runs it); its configuration
file gives the sizes and the family module; each per-layer metric is
read by ``portbench/metrics/<metric>.py``, whose ``read(r)`` returns a
number or None where it finds nothing to read.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from portbench.lib import check, peaks, spec

#: top-level modules that must not be loaded in a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cell_metrics(bench: dict, cell: str, e2e: Dict[str, float]
                 ) -> tuple[List[dict], List[dict]]:
    """(the end-to-end, the per-layer) metric entries this cell reports."""
    def reports(entry, names):
        if "workloads" in entry:
            return cell in entry["workloads"]
        return names is None or entry["moves"] in names
    ends = [e for e in bench["end_to_end"]
            if reports(e, None) and e["name"] in e2e]
    names = {e["name"] for e in ends}
    layers = [e for e in bench["per_layer"] if reports(e, names)]
    return ends, layers


def load_metric(name: str) -> Callable:
    return spec.load("metrics", name).read


def kinds() -> List[str]:
    """The traffic kinds a driver runs: the modules of ``lib/`` that
    define ``drive``."""
    return sorted(p.stem for p in (spec.BENCH / "lib").glob("*.py")
                  if hasattr(spec.load("lib", p.stem), "drive"))


def driver(kind: str):
    """The driver of traffic of kind ``kind``: ``lib/<kind>.py``."""
    if kind not in kinds():
        raise ValueError(f"no driver for traffic of kind {kind!r}; the "
                         f"kinds are {kinds()}")
    return spec.load("lib", kind)


def run_cell(bench: dict, cell: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             control: Optional[str] = None) -> dict:
    """Run ``cell`` and return its result (the keys of the result line,
    and ``lines``: what goes before it on standard error).  With
    ``control``, the driver's control stands in for the program in the
    readings that decide ``correct``."""
    entry = spec.cell_entry(bench, cell)
    cfg = config if config is not None else spec.load_config(
        bench, entry["config"])
    tr = traffic if traffic is not None else spec.load_traffic(cell)
    m = spec.model(cfg)
    kw = dict(seed=seed, seconds=seconds, trace=trace, device=device,
              control=control)
    out = driver(tr["kind"]).drive(entry["config"], cfg, tr["traffic"],
                                   **kw)
    e2e = dict(out["e2e"], setup_s=out["t0"] - t_start)
    ends, layers = cell_metrics(bench, cell, e2e)
    r = SimpleNamespace(model=m, traffic=tr["traffic"], peaks=peaks,
                        window_s=out["window_s"], work=out["work"],
                        spans=out["spans"], trace=out.get("trace"),
                        traced_work=out.get("traced_work", []))
    if trace:
        metrics = {}
        for e in layers:
            v = load_metric(e["name"])(r)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        metrics = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                   for e in ends}
    numbers, others = check.compared(out["readings"], tr["limits"])
    result = {"correct": check.passes(numbers),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info(device, out)}
    if trace and r.trace is not None:
        result["breakdown"] = {"device_ops": r.trace.top_ops(10),
                               "idle_gaps": r.trace.idle_gaps(10)}
    result["checks"] = check.as_json(numbers)
    result["lines"] = [f"note {k} = {v!r}" for k, v in
                       {**out["notes"], **out["check_info"]}.items()] \
        + [f"reading {k} = {v!r} (not compared)" for k, v in others.items()] \
        + check.lines(numbers)
    return result


def device_info(device, out: dict) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    tr = out.get("trace")
    if tr is not None:
        info["busy_s"], info["window_s"] = tr.busy_s, tr.window_s
    return info


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
