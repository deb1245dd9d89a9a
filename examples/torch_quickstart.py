"""Quickstart on the PyTorch port: the paper's Listing-2 program and the
secure pipeline DSL (``repro_torch``), beside ``quickstart.py``.

Three forms of the same idea, shortest first:

* ``listing2_average_age`` — the paper's RxLua Listing 2 on the
  plaintext Observable layer;
* ``secure_flight_pipeline`` — the DelayedFlights job in 5 fluent lines
  (``repro_torch.dsl.stream``), under full enclave mode: on the card the
  window engine's kernels seal, map and open every window;
* ``secure_flight_pipeline_spec`` — the same job from a declarative
  TOML spec (the paper's Listing-1 shape).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.observable import Observable
from repro_torch.data.synthetic import flight_chunks
from repro_torch.dsl import load_spec, stream


def listing2_average_age(device):
    """RxLua Listing 2: average age of the adult population."""
    people_ages = torch.from_numpy(
        np.random.default_rng(0).integers(1, 90, 4096).astype(np.float32)
    ).to(device)
    result = (
        Observable.from_array(people_ages, chunk_rows=512)
        .map(lambda age: age)                      # :map(person.age)
        .filter(lambda age: age > 18)              # :filter(age > 18)
        .reduce(lambda acc, age, m: {               # :reduce(...)
            "sum": acc["sum"] + float(torch.sum(age * m)),
            "count": acc["count"] + float(torch.sum(m))},
            init={"sum": 0.0, "count": 0.0})
        .subscribe(
            on_complete=lambda: print("Process complete!"))
    )
    print(f"Adult people average: {result['sum'] / result['count']:.2f}")


def secure_flight_pipeline(device):
    """map -> filter -> reduce over sealed flight records (enclave mode),
    via the fluent DSL — the paper's few-lines-of-code claim."""
    sb = (stream(flight_chunks(8192, 1024))
          .map("identity", name="sgx_mapper", sgx=True)
          .filter("delay_filter_u32", const=15, name="sgx_filter", sgx=True)
          .reduce("carrier_delay_stats", name="reducer")
          .device(device))
    out = sb.run(mode="enclave")
    count, total = np.asarray(out["count"]), np.asarray(out["sum"])
    worst = int(np.argmax(total / np.maximum(count, 1)))
    print(f"delayed flights: {int(count.sum())}; worst carrier: #{worst} "
          f"(avg {total[worst] / max(count[worst], 1):.1f} min)")
    print("stage report:", sb.report())
    return int(count.sum())


def secure_flight_pipeline_spec(device):
    """The same job, declared as a TOML spec (paper Listing 1)."""
    spec = """
    mode = "enclave"
    [stage.sgx_filter]
    op = "delay_filter_u32"
    const = 15
    constraint = "type==sgx"          # the paper's literal spelling
    [stage.reducer]
    reduce = "carrier_delay_stats"
    """
    out = load_spec(spec).device(device).run(flight_chunks(8192, 1024))
    n = int(np.asarray(out["count"]).sum())
    print(f"spec form agrees: delayed flights = {n}")
    return n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    listing2_average_age(device)
    n = secure_flight_pipeline(device)
    if secure_flight_pipeline_spec(device) != n:
        raise SystemExit("the spec form disagrees with the fluent form")


if __name__ == "__main__":
    main()
