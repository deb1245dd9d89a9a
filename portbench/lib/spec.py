"""What a cell is made of, read from its files: the configuration's sizes,
its family module, the cell's traffic, the weights and inputs drawn from
the seed.

Nothing here imports the program: the reference and the drivers share
these inputs, so both sides see the same tensors.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"

#: the family module of a configuration file without ``"reference"``
DEFAULT_REFERENCE = "dense"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    return load_json(ROOT / config_entry(bench, name)["file"])


def load_traffic(name: str) -> dict:
    """The cell's traffic and check parameters,
    ``portbench/workloads/<cell>.json``."""
    return load_json(BENCH / "workloads" / f"{name}.json")


class Model(dict):
    """A configuration's ``model`` group, whole (the port's ``ModelConfig``
    fields, sub-configurations as nested objects), and in ``reference``
    the name of its family module."""

    def __init__(self, sizes: dict, reference: str = DEFAULT_REFERENCE):
        super().__init__(sizes)
        self.reference = reference


def model(cfg: dict) -> Model:
    """The sizes the model is run with; the rest of the file (source,
    cuts, assumptions) is for the reader."""
    return Model(cfg["model"], cfg.get("reference", DEFAULT_REFERENCE))


_modules: Dict[Path, ModuleType] = {}


def load(subdir: str, name: str) -> ModuleType:
    """The module ``portbench/<subdir>/<name>.py``, loaded by its path
    under ``BENCH`` once: a family module (``reference``), a driver
    (``lib``), a metric's reader (``metrics``)."""
    path = BENCH / subdir / f"{name}.py"
    if path not in _modules:
        if not path.is_file():
            raise FileNotFoundError(f"no module {path}")
        loaded = importlib.util.spec_from_file_location(
            "portbench_" + "".join(c if c.isalnum() else "_"
                                   for c in f"{subdir}_{name}"), path)
        mod = importlib.util.module_from_spec(loaded)
        # a module's dataclasses look it up in sys.modules
        sys.modules[loaded.name] = mod
        loaded.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def family(m: Model) -> ModuleType:
    """The family module of the sizes ``m``: its layout, its FLOP and
    byte counts and its plain reference.  ``m`` has to come from
    ``model``, which carries the module's name."""
    if not isinstance(m, Model):
        raise TypeError(f"sizes of type {type(m).__name__}: the family "
                        f"module is named only on spec.model()'s Model")
    return load("reference", m.reference)


def sub_seed(seed: int, *tags: int) -> int:
    """A seed of its own for each stream drawn from ``seed`` (weights,
    each batch, the check's sample): splitmix64 over the tags."""
    x = seed & (2**64 - 1)
    for t in tags:
        x = (x + 0x9E3779B97F4A7C15 * (t + 1)) & (2**64 - 1)
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & (2**64 - 1)
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & (2**64 - 1)
        x ^= x >> 31
    return x & (2**63 - 1)


WEIGHTS, BATCH, SAMPLE, ORDER = 1, 2, 3, 4


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


# ---------------------------------------------------------------------------
# Weights, in the port's parameter layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str               # normal | ones
    std: float = 0.0
    dtype: torch.dtype = torch.bfloat16


def layout(m: Model) -> List[Leaf]:
    """Every weight of the model as the port lays it out, in draw order:
    the family module's ``layout``."""
    return [Leaf(*leaf) for leaf in family(m).layout(m)]


def make_weights(m: Model, seed: int, device) -> dict:
    """The weights drawn from ``seed`` on ``device``, each leaf in its
    type, one draw a stacked leaf, as a nested dict.  The same seed gives
    the same bits."""
    g = generator(device, seed, WEIGHTS)
    tree: dict = {}
    for leaf in layout(m):
        if leaf.init == "ones":
            t = torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
        else:
            t = torch.randn(leaf.shape, generator=g, dtype=leaf.dtype,
                            device=device).mul_(leaf.std)
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = t
    return tree


def leaves(tree: dict, prefix: Tuple[str, ...] = ()
           ) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, keys sorted."""
    if isinstance(tree, torch.Tensor):
        return [(".".join(prefix), tree)]
    return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]


# The family module's counts, under the names the metrics and tests call
# (see ``reference/dense.py``).


def matmul_weights(m: Model) -> Dict[str, int]:
    """Weight elements that multiply each token in a product, by part
    (``layers``, ``lm_head``, ``frontend``): of an MoE, the active ones."""
    return family(m).matmul_weights(m)


def attention_flops(m: Model, B: int, S: int) -> int:
    """One causal attention forward of every attention layer."""
    return family(m).attention_flops(m, B, S)


def attention_bytes(m: Model, B: int, S: int, lse: bool) -> int:
    """One attention layer's forward, each byte read or written once."""
    return family(m).attention_bytes(m, B, S, lse)


def attended_pairs(B: int, H: int, S: int) -> int:
    """(query, key) pairs of causal attention over S positions."""
    return load("reference", DEFAULT_REFERENCE).attended_pairs(B, H, S)


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------


def batch_order(traffic: dict, seed: int) -> Iterator[int]:
    """The sequence lengths of a prefill cell's batches, without end:
    cycles holding ``seq_counts[i]`` batches of ``seq_lens[i]`` each,
    every cycle in an order drawn from the seed, so every seed runs the
    same mix."""
    cycle = [s for s, c in zip(traffic["seq_lens"], traffic["seq_counts"])
             for _ in range(c)]
    rng = np.random.default_rng(sub_seed(seed, ORDER))
    while True:
        for i in rng.permutation(len(cycle)):
            yield cycle[i]


def prompts(m: dict, seed: int, index: int, B: int, S: int, device
            ) -> torch.Tensor:
    """Batch ``index``'s (B, S) int32 prompt tokens, uniform over the
    vocabulary."""
    g = generator(device, seed, BATCH, index)
    return torch.randint(0, m["vocab_size"], (B, S), generator=g,
                         dtype=torch.int32, device=device)


def train_batch(m: dict, seed: int, step: int, B: int, S: int, device
                ) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: tokens, the next tokens as labels, and a
    front end's (B, S, F) bf16 frames, N(0, 1)."""
    g = generator(device, seed, BATCH, step)
    toks = torch.randint(0, m["vocab_size"], (B, S + 1), generator=g,
                         dtype=torch.int32, device=device)
    out = {"tokens": toks[:, :-1].contiguous(),
           "labels": toks[:, 1:].contiguous()}
    frontend = m.get("frontend", "none")
    if frontend == "audio_frames":
        out["frames"] = torch.randn((B, S, m["frontend_dim"]), generator=g,
                                    dtype=torch.bfloat16, device=device)
    elif frontend != "none":
        raise ValueError(f"no traffic for the front end {frontend!r}")
    return out


def sample_requests(done: List[Tuple[int, int, int]], seed: int,
                    tokens: int) -> List[Tuple[int, int, int]]:
    """The requests the check compares, from ``done`` = [(batch, row,
    S)]: one of the longest, then others in an order drawn from the seed
    while their prompts fit in ``tokens`` more."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE))
    top = max(s for _, _, s in done)
    heads = [r for r in done if r[2] == top]
    first = heads[int(rng.integers(len(heads)))]
    out, left = [first], tokens
    for i in rng.permutation(len(done)):
        r = done[int(i)]
        if r is not first and r[2] <= left:
            out.append(r)
            left -= r[2]
    return out
