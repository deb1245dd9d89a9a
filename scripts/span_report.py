"""Where a benchmark cell's time goes by the program's own spans, on the card,
and what the spans cost.

    python3 scripts/span_report.py --cell <cell of BENCHMARK.json> [--seed N]
        [--repeats 3] [--out FILE]

Builds the cell's model, weights and inputs as ``portbench`` does, warms
the work up (a training step, or one sealed prefill of each of the
cell's lengths), then:

1. ``cost``: that work timed on the host clock, ending in a sync, with
   no tracer and with a ``repro_torch.obs.Tracer`` passed to the
   factories, in turns (A B B A, ``--repeats`` times); and one span's host
   cost alone, with ``NULL_TRACER`` and with a ``Tracer``, each with and
   without a profiler recording;
   The ``Tracer``'s spans give each span's host ms a call with no
   profiler recording;
2. ``device``: the same work once more under ``torch.profiler`` (CPU and
   CUDA).  The card's work (kernels, copies, sets) is cut by launch:
   each event's device ms under the innermost program span open when
   the host op that launched it (its ``linked_correlation_id``) began,
   with the ops that launched the most under each, and each span's host
   ms under the profiler.  The card's idle time is cut by the innermost
   open host span, as the benchmark's ``idle_*_ms.train`` metrics cut
   it, here over the profile's device window.

Also prints what the profiler bridge rests on: the torch build, whether
a CUDA-only profile sets ``torch.autograd.profiler._is_profiler_enabled``,
whether the profiler's events carry ``activity_type``, and the offset of
a range's ``start_ns()`` from ``time.time_ns()`` read just before it.
Prints one JSON object (and writes it to ``--out``).  Needs a CUDA card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: the program's spans, as ``src/repro_torch`` names them
PROGRAM_SPANS = ("serve.seal", "serve.open", "serve.prefill",
                 "attn.kv_expand", "train.fwd", "train.bwd", "attn.bwd",
                 "train.optimizer")
#: where the work runs (a CPU rehearsal of the cost part sets "cpu")
DEVICE = "cuda"


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


class TrainWork:
    """A training cell's step, on the program's path."""

    def __init__(self, name, cfg, traffic, seed):
        from portbench.lib import port, spec
        from portbench.lib.train import OPTIMIZER_KEYS
        from repro_torch.configs.base import (OptimizerConfig, RunConfig,
                                              ShapeConfig)
        from repro_torch.train.steps import make_train_step
        self.m, self.seed = spec.model(cfg), seed
        self.B, self.S = traffic["batch"], traffic["seq_len"]
        opt = cfg["optimizer"]
        self.run = RunConfig(
            model=port.model_config(name, self.m),
            shape=ShapeConfig("spans", self.S, self.B, "train"),
            optimizer=OptimizerConfig(**{k: opt[k] for k in OPTIMIZER_KEYS}),
            remat=traffic["remat"])
        self.make = make_train_step
        self.params = spec.make_weights(self.m, seed, DEVICE)
        self.state = make_train_step(self.run)[1].init(self.params)
        self.n = 0

    def fn(self, tracer):
        from portbench.lib import spec
        step = self.make(self.run, tracer=tracer)[0]

        def go():
            batch = spec.train_batch(self.m, self.seed, self.n, self.B,
                                     self.S, DEVICE)
            self.params, self.state, _ = step(self.params, self.state,
                                              batch, self.n)
            self.n += 1
        return go


class PrefillWork:
    """A prefill cell's batches, one of each length, sealed, opened,
    prefilled, their first tokens on the host."""

    def __init__(self, name, cfg, traffic, seed):
        from portbench.lib import port, spec
        from repro_torch.configs.base import RunConfig, ShapeConfig
        from repro_torch.serve import secure
        self.m, self.seed, self.secure = spec.model(cfg), seed, secure
        self.T, self.lens = traffic["tokens_per_batch"], traffic["seq_lens"]
        self.run = RunConfig(model=port.model_config(name, self.m),
                             shape=ShapeConfig("spans", 0, 0, "prefill"))
        self.weights = spec.make_weights(self.m, seed, DEVICE)
        _, self.key, _ = secure.attested_session(name)
        self.n = 0

    def fn(self, tracer):
        import torch
        from portbench.lib import spec
        from repro_torch.serve import engine

        def go():
            for S in self.lens:
                prompts = spec.prompts(self.m, self.seed, self.n,
                                       self.T // S, S, DEVICE)
                sealed = self.secure.seal_prompts(self.key, prompts, self.n,
                                                  tracer=tracer)
                opened = self.secure.open_prompts(self.key, sealed,
                                                  tracer=tracer)
                step = engine.make_prefill_step(self.run, max_seq=S,
                                                tracer=tracer)
                logits, _ = step(self.weights, {"tokens": opened})
                torch.argmax(logits, dim=-1).cpu()
                self.n += 1
        return go


def timed(go):
    sync()
    t = time.perf_counter()
    go()
    sync()
    return time.perf_counter() - t


def span_cost_ns(tracer, n):
    t = time.perf_counter_ns()
    for _ in range(n):
        with tracer.span("train.fwd"):
            pass
    return (time.perf_counter_ns() - t) / n


def cost(work, repeats):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import NULL_TRACER, Tracer
    tracer = Tracer()
    bare, traced = work.fn(NULL_TRACER), work.fn(tracer)
    times = {"bare": [], "tracer": []}
    for _ in range(repeats):
        for side, go in (("bare", bare), ("tracer", traced),
                         ("tracer", traced), ("bare", bare)):
            times[side].append(timed(go))
    out = {side: {"median_s": statistics.median(ts), "runs_s": ts}
           for side, ts in times.items()}
    out["tracer_over_bare"] = (out["tracer"]["median_s"]
                               / out["bare"]["median_s"] - 1)
    # the spans' host time with no profiler recording, a call
    calls = len(times["tracer"])
    out["host_ms_by_span_unprofiled"] = {
        n: sum(x.dur for x in tracer.find(n)) * 1e3 / calls
        for n in PROGRAM_SPANS if tracer.find(n)}
    out["span_ns"] = {"null": span_cost_ns(NULL_TRACER, 100_000),
                      "tracer": span_cost_ns(Tracer(), 100_000)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["span_ns"]["null_profiled"] = span_cost_ns(NULL_TRACER, 2_000)
        out["span_ns"]["tracer_profiled"] = span_cost_ns(Tracer(), 2_000)
    return out


def bridge():
    import torch
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile, record_function
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "card": torch.cuda.get_device_name(0)}
    with profile(activities=[ProfilerActivity.CUDA]):
        info["enabled_in_cuda_only_profile"] = \
            autograd_profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time_ns()
        with record_function("clock.probe"):
            torch.zeros(1, device=DEVICE)
        sync()
    events = prof.profiler.kineto_results.events()
    info["has_activity_type"] = all(hasattr(e, "activity_type")
                                    for e in events)
    probe = [e for e in events if e.name() == "clock.probe"]
    info["probe_start_minus_time_ns_ms"] = [(e.start_ns() - t) / 1e6
                                            for e in probe]
    return info


def top(by_owner, n=6):
    """{owner: {name: ns}} -> {owner: [[name, ms], ...]}, the longest
    ``n`` of each."""
    return {k: [[name, ns / 1e6] for name, ns in sorted(
        v.items(), key=lambda kv: -kv[1])[:n]]
        for k, v in sorted(by_owner.items())}


def device_by_span(work, names):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from portbench.lib import spans, trace
    from repro_torch.obs import NULL_TRACER
    go = work.fn(NULL_TRACER)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        go()
        sync()
    dev, host, op_start, op_name = [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        ev = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            # the harness's own test of work (``portbench/lib/trace.py``)
            if trace.is_work(e):
                dev.append((e.linked_correlation_id(), ev))
        else:
            if e.name() in PROGRAM_SPANS:
                host.append(ev)
            if e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = s
                op_name[e.correlation_id()] = e.name()
    window = (min(s for _, (_, s, _) in dev), max(t for _, (_, _, t) in dev))
    busy = trace.union([(s, t) for _, (_, s, t) in dev])
    # launches precede their work: cut the host's time from its first op
    by_host = spans.innermost(host, PROGRAM_SPANS, (
        min([window[0], *op_start.values()]), window[1]))
    launched, launch_ops = {}, {}
    for corr, (name, s, t) in dev:
        at = op_start.get(corr) if corr else None
        owner = "unlinked" if at is None else next(
            (n or "outside" for a, b, n in by_host if a <= at < b), "outside")
        launched[owner] = launched.get(owner, 0) + (t - s)
        key = f"{op_name.get(corr, '?')} / {name[:60]}"
        by = launch_ops.setdefault(owner, {})
        by[key] = by.get(key, 0) + (t - s)
    idle = spans.idle_ns(SimpleNamespace(host=host, host_busy=busy,
                                         host_window=window), names)
    return {"window_ms": (window[1] - window[0]) / 1e6,
            "busy_ms": sum(t - s for s, t in busy) / 1e6,
            "launched_ms_by_span": {k: v / 1e6
                                    for k, v in sorted(launched.items())},
            "idle_ms_by_span": {k or "outside": v / 1e6
                                for k, v in sorted(idle.items())},
            "top_launch_ops_ms": top(launch_ops),
            "host_ms_by_span": {n: sum(t - s for m, s, t in host if m == n)
                                / 1e6 for n in PROGRAM_SPANS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import spec, spans
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, args.cell)
    tr = spec.load_traffic(args.cell)
    cfg = spec.load_config(bench, entry["config"])
    kind = {"train": (TrainWork, spans.STEP_SPANS),
            "prefill": (PrefillWork, PROGRAM_SPANS)}
    make, names = kind[tr["kind"]]
    work = make(entry["config"], cfg, tr["traffic"], args.seed)
    from repro_torch.obs import NULL_TRACER
    for _ in range(2):
        timed(work.fn(NULL_TRACER))
    out = {"cell": args.cell, "bridge": bridge(),
           "cost": cost(work, args.repeats),
           "device": device_by_span(work, names)}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
