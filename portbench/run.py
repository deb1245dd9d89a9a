"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its configuration, traffic
and per-layer metrics are files under ``portbench/`` found by name.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the numbers compared are also the last lines of standard error.
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2; with JAX or the JAX package loaded, with 3.

``--control fp8`` (training cells also ``--control half_batch``) runs
the cell as usual but judges, in the program's place, the reference
computed one precision below the configuration's or with that fault
planted: its ``correct`` has to come out false.  The benchmark's own
runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8", "half_batch"),
                    help="judge this control in the program's place")
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import runner, spec
    bench = spec.benchmark()
    chips = spec.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this host "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    print(f"card {card()}", file=sys.stderr, flush=True)
    result = runner.run_cell(bench, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=bool(args.trace),
                             device="cuda", t_start=T_START,
                             control=args.control)
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for line in result.pop("lines"):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
