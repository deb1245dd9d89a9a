"""The sealed-prefill driver: one client in a closed loop seals a batch of
prompts, the server opens it, prefills it and sends back each prompt's
first token; the client sends the next batch when the tokens arrive.

A batch holds ``tokens_per_batch`` prompt tokens: B = tokens / S prompts
of S tokens, S from the cell's mix (:func:`spec.batch_order`).  A
request's time to first token runs from when its batch is due (the
client starts sealing) to its token on the host.  The window runs
batches until ``seconds`` have passed and closes when the batch in
flight has its tokens.

With ``control="fp8"`` the check reads the control in the program's
place: the reference computed in fp8 (the family module's
``last_logits``), its logits and its own first tokens for the same
sampled requests.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from portbench.lib import check, port, spec
from portbench.lib.trace import record

#: the end-to-end metrics a prefill cell reports, beside ``setup_s``
END_TO_END = ("ttft_p95_ms", "prompt_tokens_per_s")
#: the controls a prefill cell reads in the program's place
CONTROLS = ("fp8",)
#: the counters of the batches drawn outside the window (warm-up, trace)
WARM, TRACED = 1 << 40, 1 << 41
#: the prompt tokens of the requests the check compares beside the
#: longest: the reference's f32 prefill takes ~2 s a thousand tokens of
#: granite-34b, so the check stays shorter than the window
SAMPLE_TOKENS = 8192


class Server:
    """The program's serving path for one configuration."""

    def __init__(self, name: str, m: dict, weights: dict) -> None:
        from repro_torch.configs.base import RunConfig, ShapeConfig
        from repro_torch.serve import secure
        self.secure = secure
        self.run = RunConfig(model=port.model_config(name, m),
                             shape=ShapeConfig("portbench", 0, 0, "prefill"))
        self.weights = weights
        _, self.key, _ = secure.attested_session(name)

    def serve(self, prompts: torch.Tensor, counter: int, spans: Dict):
        """Seal, open, prefill, first tokens to the host -> (opened
        prompts, (B, V) f32 last logits, (B,) first tokens on the host)."""
        from repro_torch.serve import engine
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function("portbench.seal_open"):
            sealed = self.secure.seal_prompts(self.key, prompts, counter)
            opened = self.secure.open_prompts(self.key, sealed)
        spans.setdefault("seal_open", []).append(time.perf_counter() - t0)
        with record_function("portbench.prefill"):
            step = engine.make_prefill_step(self.run,
                                            max_seq=opened.shape[1])
            logits, cache = step(self.weights, {"tokens": opened})
            del cache
        with record_function("portbench.first_token"):
            first = torch.argmax(logits, dim=-1).to(torch.int32).cpu()
        return opened, logits, first


def drive(name: str, cfg: dict, traffic: dict, *, seed: int, seconds: float,
          trace: bool, device, control: Optional[str] = None) -> dict:
    from repro_torch.kernels import build
    m = spec.model(cfg)
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the prefill driver runs one client in a closed "
                         "loop")
    if control not in (None,) + CONTROLS:
        raise ValueError(f"a prefill cell has no control {control!r}")
    weights = spec.make_weights(m, seed, device)
    server = Server(name, m, weights)
    T = traffic["tokens_per_batch"]
    for j, S in enumerate(traffic["seq_lens"]):          # every shape once
        server.serve(spec.prompts(m, seed, WARM + j, T // S, S, device),
                     WARM + j, {})
    port.sync(device)

    spans: Dict[str, List[float]] = {}
    kept, ttft = [], []
    build.reset_launch_counts()
    t0 = time.perf_counter()
    for i, S in enumerate(spec.batch_order(traffic, seed)):
        prompts = spec.prompts(m, seed, i, T // S, S, device)
        due = time.perf_counter()
        opened, logits, first = server.serve(prompts, i, spans)
        t = time.perf_counter()
        ttft += [t - due] * (T // S)
        kept.append((S, opened, logits, first))
        if t - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    launches = build.launch_counts()
    out = {"t0": t0, "window_s": window_s,
           "work": [(T // S, S) for S, *_ in kept], "spans": spans,
           "memory_peak_bytes": port.peak_bytes(device),
           "attempted": len(ttft), "failed": 0,
           "e2e": {"ttft_p95_ms": percentile(ttft, 95) * 1e3,
                   "prompt_tokens_per_s": T * len(kept) / window_s},
           "notes": {"batches": len(kept), "requests": len(ttft),
                     "ttft_p50_ms": percentile(ttft, 50) * 1e3,
                     "launches_a_prefill": {k: v / len(kept) for k, v in
                                            launches.items() if v}}}
    if trace:
        def work(p):               # one batch of each length
            for j, S in enumerate(traffic["seq_lens"]):
                c = TRACED + 64 * p + j
                server.serve(spec.prompts(m, seed, c, T // S, S, device), c,
                             {})
        out["trace"] = record(work)
        out["traced_work"] = [(T // S, S) for S in traffic["seq_lens"]]
    port.free(device)
    out["readings"], out["check_info"] = judge(m, T, seed, weights, kept,
                                               device, control)
    return out


def judge(m, T, seed, weights, kept, device, control=None):
    """The sealed round trip of every batch; the logits of a sample of
    requests, the longest among them, against the reference: the served
    token's gap below the reference's best, and the logits' relative L2
    distance, each the widest of the sample.  With ``control``, the
    control's logits and tokens stand in for the program's."""
    mismatches = sum(
        int(not torch.equal(opened, spec.prompts(m, seed, i, T // S, S,
                                                 device)))
        for i, (S, opened, _, _) in enumerate(kept))
    sample = sample_of(T, [S for S, *_ in kept], seed)
    if control is None:
        logits = torch.stack([kept[i][2][r] for i, r, _ in sample])
        tokens = torch.stack([kept[i][3][r] for i, r, _ in sample])
    else:
        logits = reference_logits(m, T, seed, weights, sample, device,
                                  fp8=True)
        tokens = logits.argmax(dim=-1)
    gaps, rels = check.logit_numbers(
        logits, tokens, reference_logits(m, T, seed, weights, sample, device))
    return ({"roundtrip_mismatches": float(mismatches),
             "logit_gap": max(gaps), "logits_rel_l2": max(rels)},
            {"sampled_requests": len(sample),
             "sampled_tokens": sum(s for _, _, s in sample),
             "longest": max(s for _, _, s in sample)})


def sample_of(T: int, lengths: List[int], seed: int):
    """The (batch, row, S) requests compared, of batches of ``lengths``."""
    done = [(i, r, S) for i, S in enumerate(lengths) for r in range(T // S)]
    return spec.sample_requests(done, seed, SAMPLE_TOKENS)


def reference_logits(m, T, seed, weights, sample, device, fp8=False):
    """The reference's last logits of each sampled request, in order; the
    requests of one length in one call."""
    last_logits = spec.family(m).last_logits
    out = [None] * len(sample)
    for S in sorted({s for _, _, s in sample}, reverse=True):
        idx = [j for j, (_, _, s) in enumerate(sample) if s == S]
        toks = torch.cat([spec.prompts(m, seed, sample[j][0], T // S, S,
                                       device)[sample[j][1]][None]
                          for j in idx])
        logits = last_logits(m, weights, toks, fp8=fp8)
        for k, j in enumerate(idx):
            out[j] = logits[k]
    return torch.stack(out)


def percentile(xs: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    ys = sorted(xs)
    return ys[max(0, -(-len(ys) * q // 100) - 1)]
