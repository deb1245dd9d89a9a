"""What a cell is made of, read from its files: the configuration's sizes,
the cell's traffic, the weights and inputs drawn from the seed.

Nothing here imports the program: the reference and the drivers share
these inputs, so both sides see the same tensors.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"

#: the keys of a configuration file that size the model; the rest of the
#: file (source, cuts, assumptions) is for the reader
MODEL_KEYS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "mlp_type", "rope_theta",
              "rms_eps", "tie_embeddings", "qkv_bias", "frontend",
              "frontend_dim")


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


def model(cfg: dict) -> dict:
    """The sizes the model is run with."""
    return {k: cfg["model"][k] for k in MODEL_KEYS}


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


def layout(m: dict) -> List[Leaf]:
    """Every weight of a dense decoder (the dense, audio and vision
    families: attention + MLP a layer) as the port lays it out: stacked
    ``(L, ...)`` layers, ``x @ W`` matrices of (fan_in, fan_out), norms as
    gains, a separate LM head unless tied.  A matrix is drawn N(0,
    1/fan_in), the embedding N(0, 0.02^2), a gain is 1."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    hd = m["num_heads"] * m["head_dim"]
    kd = m["num_kv_heads"] * m["head_dim"]
    F = m["d_ff"]
    mats = {("attn", "wq"): (d, hd), ("attn", "wk"): (d, kd),
            ("attn", "wv"): (d, kd), ("attn", "wo"): (hd, d),
            ("mlp", "wu"): (d, F), ("mlp", "wd"): (F, d)}
    if m["mlp_type"] == "swiglu":
        mats[("mlp", "wg")] = (d, F)
    leaves = [Leaf(("embed",), (V, d), "normal", 0.02),
              Leaf(("final_norm",), (d,), "ones")]
    if not m["tie_embeddings"]:
        leaves.append(Leaf(("lm_head",), (d, V), "normal", d ** -0.5))
    if m["frontend"] != "none":
        leaves.append(Leaf(("frontend_proj",), (m["frontend_dim"], d),
                           "normal", m["frontend_dim"] ** -0.5))
    leaves += [Leaf(("layers", "ln1"), (L, d), "ones"),
               Leaf(("layers", "ln2"), (L, d), "ones")]
    for (group, name), (fi, fo) in sorted(mats.items()):
        leaves.append(Leaf(("layers", group, name), (L, fi, fo), "normal",
                           fi ** -0.5))
    if m["qkv_bias"]:
        raise ValueError("the harness draws no attention biases")
    return sorted(leaves, key=lambda s: s.path)


def make_weights(m: dict, seed: int, device) -> dict:
    """The weights drawn from ``seed`` on ``device`` in bf16, one draw a
    stacked leaf, as a nested dict.  The same seed gives the same bits."""
    g = generator(device, seed, WEIGHTS)
    tree: dict = {}
    for leaf in layout(m):
        if leaf.init == "ones":
            t = torch.ones(leaf.shape, dtype=torch.bfloat16, device=device)
        else:
            t = torch.randn(leaf.shape, generator=g, dtype=torch.bfloat16,
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


def matmul_weights(m: dict) -> Dict[str, int]:
    """Weight elements that multiply every token in a product, by part:
    the layers' projections and MLP, the LM head, the front end's
    projector.  The embedding is gathered, not multiplied."""
    d = m["d_model"]
    per_layer = sum(math.prod(l.shape[1:]) for l in layout(m)
                    if l.path[0] == "layers" and len(l.shape) == 3)
    return {"layers": per_layer * m["num_layers"],
            "lm_head": d * m["vocab_size"],
            "frontend": m["frontend_dim"] * d if m["frontend"] != "none"
            else 0}


def attended_pairs(B: int, H: int, S: int) -> int:
    """(query, key) pairs of causal attention over S positions."""
    return B * H * S * (S + 1) // 2


def attention_flops(m: dict, B: int, S: int) -> int:
    """One causal attention forward of every layer: 2·D for q·k and 2·D
    for p·v a pair, at the real head dim."""
    return m["num_layers"] * 4 * m["head_dim"] * attended_pairs(
        B, m["num_heads"], S)


def attention_bytes(m: dict, B: int, S: int, lse: bool) -> int:
    """One layer's attention forward, each byte read or written once:
    bf16 queries and outputs of every head, keys and values of the
    key/value heads, and with ``lse`` its (B, H, S) f32 log-sum-exp."""
    H, K, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    n = 2 * B * S * D * (2 * H + 2 * K)
    return n + (4 * B * H * S if lse else 0)


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
    if m["frontend"] == "audio_frames":
        out["frames"] = torch.randn((B, S, m["frontend_dim"]), generator=g,
                                    dtype=torch.bfloat16, device=device)
    elif m["frontend"] != "none":
        raise ValueError(f"no traffic for the front end {m['frontend']!r}")
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
