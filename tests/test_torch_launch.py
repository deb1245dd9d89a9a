"""The port's launch layer (``repro_torch.launch``) against the
reference's ``repro.launch`` on the CPU.

``repro/launch/dryrun.py`` sets ``XLA_FLAGS`` when it is imported (512
host devices), so the reference's side runs in ONE subprocess (as
``tests/test_torch_collectives.py`` runs its W = 4 oracle) that writes
JSON: for all 40 (arch, shape) cells its ``input_specs`` (shapes and
dtypes) and ``model_flops``, and for every arch its ``abstract_params``
and ``abstract_cache`` leaf by leaf.  The port's side: the same for its
``launch.dryrun`` and ``models.api``; the one card's mesh; the op-level
analyzer's FLOP, byte, collective, memory and loop-scaling models on
small functions; the hier schedule's FLOPs beside kernel 7's.  Every
cell through ``run_cell`` and the command line:
``tests/test_torch_launch_cells.py``; the analyzer against the
reference's HLO analysis: ``tests/test_torch_launch_hlo.py``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import ARCH_IDS, SHAPES, get_run_config
from repro_torch.dist import collectives, meshctx
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun, mesh
from repro_torch.models import api
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
CACHE_SHAPE = (2, 64)        # abstract_cache's (batch, max_seq)

_REFERENCE = """
import json, sys
from repro.launch import dryrun            # sets XLA_FLAGS first
import jax
from repro.configs import ARCH_IDS, SHAPES, get_model_config, get_run_config
from repro.models import api

def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): [list(x.shape), str(x.dtype)]
            for path, x in flat}

out = {"cells": {}, "params": {}, "cache": {}}
for a in ARCH_IDS:
    for s in SHAPES:
        run = get_run_config(a, s)
        out["cells"][a + "|" + s] = {
            "specs": {k: [list(v.shape), str(v.dtype)]
                      for k, v in dryrun.input_specs(run).items()},
            "model_flops": dryrun.model_flops(run)}
    cfg = get_model_config(a)
    out["params"][a] = leaves(api.abstract_params(cfg))
    out["cache"][a] = leaves(api.abstract_cache(cfg, %d, %d))
json.dump(out, sys.stdout)
""" % CACHE_SHAPE


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: [list(tree.shape), _dtype(tree)]}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_equal_the_reference(reference, arch,
                                                         shape):
    run = get_run_config(arch, shape)
    want = reference["cells"][f"{arch}|{shape}"]
    specs = dryrun.input_specs(run)
    assert all(t.device.type == "meta" for t in specs.values())
    assert {k: [list(t.shape), _dtype(t)] for k, t in specs.items()} == \
        want["specs"]
    assert dryrun.model_flops(run) == want["model_flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_cache_equal_the_reference(reference, arch):
    """Leaf for leaf (path, shape, dtype), on meta, nothing allocated."""
    cfg = configs.get_model_config(arch)
    params = api.abstract_params(cfg)
    cache = api.abstract_cache(cfg, *CACHE_SHAPE)
    for tree in (params, cache):
        assert all(t.device.type == "meta" for t in _leaves_t(tree))
    assert _leaves(params) == reference["params"][arch]
    assert _leaves(cache) == reference["cache"][arch]


def _leaves_t(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree.values() for t in _leaves_t(v)]


def test_production_mesh_is_one_card():
    m = mesh.make_production_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.axis_names == ("data", "model")
    assert mesh.make_smoke_mesh is meshctx.make_smoke_mesh
    with pytest.raises(ValueError, match="multi-card torch.distributed"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")


def test_analyzer_counts_products_bytes_and_live_storage():
    """A hand-countable function: one (8, 16) @ (16, 32) product, an
    elementwise op, a view and an in-place op."""
    x = torch.empty((8, 16), device="meta")
    w = torch.empty((16, 32), device="meta")

    def fn(x, w):
        y = x @ w                       # 2*8*16*32 FLOPs; reads x, w
        z = torch.relu(y)               # a new (8, 32)
        del y
        z.t()                           # a view: no traffic
        z.add_(1.0)                     # reads and writes z
        return z
    an, out = A.analyze(fn, x, w)
    f4 = 4
    assert an.flops == 2 * 8 * 16 * 32
    assert an.flops_by_op == {"aten.mm": 2 * 8 * 16 * 32}
    assert an.bytes == f4 * ((8 * 16 + 16 * 32 + 8 * 32)     # mm
                             + 2 * 8 * 32                     # relu
                             + 2 * 8 * 32)                    # add_
    assert an.argument_bytes == f4 * (8 * 16 + 16 * 32)
    assert an.peak_live_bytes == an.argument_bytes + 2 * f4 * 8 * 32
    assert an.output_bytes == f4 * 8 * 32 and an.alias_bytes == 0
    assert out.device.type == "meta"
    with pytest.raises(ValueError, match="meta"):
        A.analyze(fn, torch.zeros((8, 16)), torch.zeros((16, 32)))


def test_analyzer_counts_collectives():
    """The port's one collective, seen through its observer hook: the
    bytes that change workers.  (The one-card steps issue none.)"""
    m = meshctx.make_mesh((4,), ("model",), device="meta")
    x = torch.empty((4, 4, 16), dtype=torch.int32, device="meta")
    an, _ = A.analyze(lambda x: collectives.exchange(x, m), x)
    assert an.collective_count == 1
    assert an.collective_bytes == 4 * 4 * 16 * 4 * 3 // 4
    assert an.collective_by_kind == {"all-to-all": an.collective_bytes}
    assert collectives._OBSERVERS == []


@pytest.mark.parametrize("train", [False, True])
def test_scaled_slstm_loop_counts_what_the_full_loop_counts(train):
    """xlstm's sLSTM counted from two trips equals the loop run trip by
    trip: FLOPs exactly, bytes and ops within the markers' views and (in
    the backward) the gradient sums of the repeated h."""
    cfg = configs.reduce_for_smoke(configs.get_model_config("xlstm-125m"))
    from repro_torch.models import xlstm
    params = api.abstract_params(cfg)
    p = {k: v[0] for k, v in params["layers"]["slstm"].items()}
    x = torch.empty((2, 48, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")

    def fn(p, x):
        if not train:
            return xlstm.slstm_forward(p, x, cfg)
        live = {k: v.detach().requires_grad_() for k, v in p.items()}
        y = xlstm.slstm_forward(live, x, cfg)
        return torch.autograd.grad(y.float().sum(), list(live.values()))
    full, _ = A.analyze(fn, p, x)
    scaled, _ = A.analyze(fn, p, x, scale_loops=True)
    assert scaled.loop_scaled == [dict(
        loop="repro_torch.models.xlstm._slstm_scan", trips=48,
        counted_trips=2, scaled_by=47,
        live_bytes_per_trip=scaled.loop_scaled[0]["live_bytes_per_trip"])]
    assert full.loop_scaled == []
    assert scaled.flops == full.flops > 0
    assert abs(scaled.bytes - full.bytes) <= 0.05 * full.bytes
    assert abs(scaled.ops - full.ops) <= 0.05 * full.ops
    assert abs(scaled.peak_live_bytes - full.peak_live_bytes) <= \
        0.25 * full.peak_live_bytes


def test_the_analyzer_names_no_model_module_and_patches_none():
    """A model's loop is scaled through the trip-count marker the model
    itself calls (``models.loop.scan``), which hands it to the scaler the
    analyzer registers: the analyzer imports no model module but the
    marker's, names none, and assigns to no attribute of a module."""
    import ast
    import re
    from repro_torch.models import loop, xlstm
    src = Path(A.__file__).read_text()
    tree = ast.parse(src)
    modules = {a.asname or a.name.split(".")[0] for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))
               for a in n.names}
    imported = [f"{n.module}.{a.name}" for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names] + [
        a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
        for a in n.names]
    assert [m for m in imported if "models" in m] == \
        ["repro_torch.models.loop"]
    names = sorted(p.stem for p in (ROOT / "src" / "repro_torch" /
                                    "models").glob("*.py")
                   if p.stem not in ("__init__", "flash", "layers", "api",
                                     "loop"))
    assert names and not re.findall(
        r"\b(%s)\b" % "|".join(names), src.lower())
    assert "setattr(" not in src
    assert re.findall(r"repro_torch\.models\.(\w+)", src) == ["loop"]
    # the models layer imports nothing of the launch layer
    assert "repro_torch.launch" not in Path(xlstm.__file__).read_text()
    assert "repro_torch.launch" not in Path(loop.__file__).read_text()
    patched = [t for n in ast.walk(tree)
               if isinstance(n, (ast.Assign, ast.AugAssign))
               for t in (n.targets if isinstance(n, ast.Assign)
                         else [n.target])
               if isinstance(t, ast.Attribute)
               and isinstance(t.value, ast.Name) and t.value.id in modules]
    assert not patched


def test_hier_attention_halves_the_all_blocks_flops():
    """The reference's ``test_hier_attention_halves_hlo_flops``: at S =
    512 the recursive-halving schedule counts < 0.65x the FLOPs of the
    attention computing every (q, kv) block (the reference's flash
    computes the masked blocks too).  The port's kernel 7 counts only the
    causal pairs, so hier is not below it: its gain is already there."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.hier_attn import hier_causal_attention
    q = torch.empty((1, 512, 1, 16), device="meta")
    hier, _ = A.analyze(lambda q, k, v: hier_causal_attention(
        q, k, v, base=64, q_chunk=64, kv_chunk=64), q, q, q)
    every, _ = A.analyze(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=False), q, q, q)
    kernel, _ = A.analyze(lambda q, k, v: ops.flash_attention(q, k, v),
                          q, q, q)
    assert every.flops == 4 * 16 * 512 * 512
    assert hier.flops < 0.65 * every.flops
    assert kernel.flops <= hier.flops <= 1.15 * kernel.flops
