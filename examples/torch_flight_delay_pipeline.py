"""End-to-end run on the PyTorch port: the paper's DelayedFlights
macro-benchmark (§5.2), beside ``flight_delay_pipeline.py``.

Computes per-carrier average delay + delayed-flight counts over a
synthetic BTS-style stream under any of the three Fig.-6 security
configurations, with per-stage worker scaling — declared in a few lines
via the fluent DSL (``repro_torch.dsl``; ``--spec`` loads the
equivalent TOML spec instead).

Run:  PYTHONPATH=src python examples/torch_flight_delay_pipeline.py \\
          --mode enclave --workers 2 --records 65536 [--device cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.securestreams_flightdelay import CONFIG
from repro_torch.data.synthetic import flight_chunks
from repro_torch.dsl import load_spec, stream

SPEC_PATH = os.path.join(os.path.dirname(__file__), "flight_delay.toml")


def build_pipeline(mode: str, workers: int, device):
    """The paper's Listing-1 job, fluent form (the TOML spec next to this
    file is the declarative equivalent)."""
    return (stream()
            .map("identity", name="sgx_mapper", workers=workers, sgx=True)
            .filter("delay_filter_u32", const=15, name="sgx_filter",
                    workers=workers, sgx=True)
            .reduce("carrier_delay_stats", name="reducer")
            .secure(mode)
            .device(device))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default=CONFIG.secure.mode,
                    choices=["plain", "encrypted", "enclave"])
    ap.add_argument("--workers", type=int, default=CONFIG.workers_per_stage)
    ap.add_argument("--records", type=int, default=65_536)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spec", action="store_true",
                    help=f"build from the TOML spec ({SPEC_PATH}) instead "
                         f"of the fluent chain")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record per-window spans and write a Chrome-trace "
                         "JSON here")
    args = ap.parse_args()
    device = torch.device(args.device)

    if args.spec:
        pipe = (load_spec(SPEC_PATH).secure(args.mode).device(device)
                .scale("sgx_mapper", args.workers)
                .scale("sgx_filter", args.workers))
    else:
        pipe = build_pipeline(args.mode, args.workers, device)
    if args.trace:
        pipe = pipe.trace()
    src = flight_chunks(args.records, args.chunk * args.workers, seed=1)
    t0 = time.perf_counter()
    out = pipe.run(src)
    dt = time.perf_counter() - t0
    mb = args.records * 64 / 1e6

    print(f"mode={args.mode} workers={args.workers} device={device} "
          f"records={args.records} ({mb:.1f} MB)")
    print(f"pipeline: {pipe.describe()}")
    print(f"completed in {dt:.2f}s  ({mb / dt:.2f} MB/s)")
    count, total = np.asarray(out["count"]), np.asarray(out["sum"])
    print(f"{'carrier':>8} {'delayed':>9} {'avg delay':>10}")
    for c in range(CONFIG.num_carriers):
        n = int(count[c])
        print(f"{c:>8} {n:>9} {total[c] / max(n, 1):>9.1f}m")
    print("stage report:")
    for name, rep in pipe.report().items():
        print(f"  {name:12s} {rep}")
    if args.trace:
        pipe.tracer.export_chrome(args.trace)
        print(f"wrote {args.trace} ({len(pipe.tracer)} spans)")


if __name__ == "__main__":
    main()
