"""The dry run: every (arch, shape) cell's step counted without
allocating (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for a TPU v5e pod and reads
the compiled HLO.  The port runs each cell's own step functions once on
``meta`` tensors (:func:`trace_cell`: :func:`repro_torch.train.steps.
make_train_step` with the optimizer state made on meta,
:func:`repro_torch.serve.engine.make_prefill_step` and
``make_decode_step``) under the op-level analyzer
(:mod:`repro_torch.launch.analysis`), on the one card's mesh, and turns
the counts into compute, memory and collective times against the card's
peaks (:func:`roofline`).  Nothing is allocated and nothing launched, so
it runs on any host, no GPU needed::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b

writes one JSON a cell, ``{arch}__{shape}__h100x1.json``, under
``experiments/dryrun/`` with the reference's keys (``status``,
``memory``, ``roofline``, ...; ``compile_s`` and ``xla_cost`` are null:
nothing compiles) and ``fits_one_card`` (the peak estimate against the
card's 80 GB).  ``chip_smoke.py`` phase 15 sets it beside measured steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_supported,
                                 get_run_config)
from repro_torch.configs.base import RunConfig
from repro_torch.launch import analysis as A
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api as model_api
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.steps import make_train_step

#: the card the port runs on, and its peaks: NVIDIA H100 SXM data sheet
#: figures (dense bf16 tensor cores, HBM3), at its 700 W power limit
#: ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi names it).
#: chip_smoke.py's bounds read the same two constants.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12            # bf16, FLOP/s
HBM_BW = 3.35e12               # bytes/s
#: NVLink, bytes/s each way per card: for the record only, as a step on
#: one card issues no collective (t_coll_s is 0)
LINK_BW = 450e9
#: the card's device memory, bytes: a cell whose peak estimate exceeds it
#: does not fit one card (recorded, not an error)
HBM_BYTES = 80e9
MESH_NAME = "h100x1"

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")


def input_specs(run: RunConfig) -> Dict[str, torch.Tensor]:
    """Model inputs for one step of the cell's kind (train/prefill/decode),
    as empty ``meta`` tensors."""
    cfg, shape = run.model, run.shape
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    i32 = torch.int32
    if shape.kind == "train":
        out = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
    elif shape.kind == "prefill":
        out = {"tokens": sds((B, S), i32)}
    else:  # decode: one new token against a cache of S
        out = {"tokens": sds((B, 1), i32)}
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        out["patches"] = sds((B, 256, cfg.frontend_dim), torch.bfloat16)
    elif cfg.frontend == "audio_frames" and shape.kind != "decode":
        out["frames"] = sds((B, S, cfg.frontend_dim), torch.bfloat16)
    return out


def trace_cell(run: RunConfig) -> Tuple[A.Analysis, Any]:
    """Run the cell's step once on meta tensors under the analyzer, its
    loops scaled (:func:`repro_torch.launch.analysis.analyze`).  -> (its
    analysis, the step's result)."""
    cfg, shape = run.model, run.shape
    params = model_api.abstract_params(cfg)
    batch = input_specs(run)
    if shape.kind == "train":
        step_fn, opt = make_train_step(run)
        opt_state = opt.init(params)
        return A.analyze(step_fn, params, opt_state, batch, 0,
                         scale_loops=True)
    if shape.kind == "prefill":
        step_fn = make_prefill_step(run, max_seq=shape.seq_len)
        return A.analyze(step_fn, params, batch, scale_loops=True)
    # decode: the last position of a full cache of S
    B, S = shape.global_batch, shape.seq_len
    cache = model_api.abstract_cache(cfg, B, S)
    return A.analyze(make_decode_step(run), params, batch["tokens"], S - 1,
                     cache, scale_loops=True)


def model_flops(run: RunConfig) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = run.model.active_param_count()
    if run.shape.kind == "train":
        return 6.0 * n * run.shape.tokens
    if run.shape.kind == "prefill":
        return 2.0 * n * run.shape.tokens
    return 2.0 * n * run.shape.global_batch  # decode: one token per sequence


def roofline(run: RunConfig, analysis: A.Analysis,
             nchips: int) -> Dict[str, Any]:
    t_compute = analysis.flops / PEAK_FLOPS
    t_mem = analysis.bytes / HBM_BW
    t_coll = analysis.collective_bytes / LINK_BW
    terms = {"t_compute_s": t_compute, "t_mem_s": t_mem, "t_coll_s": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(run) / nchips
    longest = max(t_compute, t_mem, t_coll)
    return {
        **terms,
        "dominant": dom,
        "hlo_flops_per_chip": analysis.flops,
        "hlo_bytes_per_chip": analysis.bytes,
        "collective_bytes_per_chip": analysis.collective_bytes,
        "collective_by_kind": analysis.collective_by_kind,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": (mf / analysis.flops) if analysis.flops else 0.0,
        "roofline_fraction": (mf / PEAK_FLOPS) / longest if longest else 0.0,
    }


def run_cell(arch: str, shape: str, mesh: str = "card",
             out_dir: str = OUT_DIR, force: bool = False,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Count one cell and write its record (or return the one written
    before, unless ``force``).  ``overrides`` go to ``get_run_config``;
    ``shape=ShapeConfig(...)`` among them replaces the cell's shape (a
    card-sized one, say) while the record keeps the cell's name."""
    if mesh != "card":
        raise ValueError(f"dryrun: mesh {mesh!r}; the port's production "
                         f"mesh is one card ('card')")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{MESH_NAME}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    ok, reason = cell_supported(arch, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": MESH_NAME,
                           "timestamp": time.time()}
    if not ok:
        rec.update(status="skipped", reason=reason)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        return rec

    ov = dict(overrides or {})
    shape_cfg = ov.pop("shape", None)     # the positional name takes it
    run = get_run_config(arch, shape, **ov)
    if shape_cfg is not None:
        run = dataclasses.replace(run, shape=shape_cfg)
    nchips = math.prod(make_production_mesh(device="meta").shape.values())
    t0 = time.time()
    try:
        an, _ = trace_cell(run)
        peak = an.peak_live_bytes
        rec.update(
            status="ok",
            lower_s=round(time.time() - t0, 2),
            compile_s=None,
            nchips=nchips,
            card=CARD,
            run_shape={"seq_len": run.shape.seq_len,
                       "global_batch": run.shape.global_batch,
                       "kind": run.shape.kind},
            memory={
                "argument_bytes": an.argument_bytes,
                "output_bytes": an.output_bytes,
                "temp_bytes": peak - an.argument_bytes,
                "alias_bytes": an.alias_bytes,
                "peak_estimate_bytes": peak,
            },
            fits_one_card=peak <= HBM_BYTES,
            xla_cost=None,
            roofline=roofline(run, an, nchips),
            collective_count=an.collective_count,
            flops_by_op=an.flops_by_op,
            ops=an.ops,
            loop_scaled=an.loop_scaled,
        )
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def fmt_cell(rec: Dict[str, Any]) -> str:
    if rec["status"] == "skipped":
        return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:7s} "
                f"SKIP ({rec['reason'][:50]}...)")
    if rec["status"] == "error":
        return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:7s} "
                f"ERROR {rec['error'][:80]}")
    r = rec["roofline"]
    peak = rec["memory"]["peak_estimate_bytes"] / 1e9
    fits = "" if rec["fits_one_card"] else " (over one card)"
    return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:7s} ok "
            f"trace={rec['lower_s']:6.1f}s mem={peak:8.2f}GB{fits} "
            f"tc={r['t_compute_s']:.3e} tm={r['t_mem_s']:.3e} "
            f"tx={r['t_coll_s']:.3e} dom={r['dominant'][2:]:8s} "
            f"roofline={r['roofline_fraction']:.3f}")


def main() -> None:
    ap = argparse.ArgumentParser(description="One-card dry run")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="card", choices=["card"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_err = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, args.mesh, out_dir=args.out,
                           force=args.force)
            print(fmt_cell(rec), flush=True)
            n_err += rec["status"] == "error"
    if n_err:
        raise SystemExit(f"{n_err} cells failed")


if __name__ == "__main__":
    main()
