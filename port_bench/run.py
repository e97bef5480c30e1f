"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's program is set up (kernels loaded from the build directory in the
checkout, built there on a checkout's first run; weights and inputs made on
the card from the seed; every shape warmed), then called for `--seconds`;
with `--trace 1` the window runs under `torch.profiler` and the line holds
the per-layer metrics, else the end-to-end ones (a cell whose end-to-end
rate counts the card's busy time records the device's activity alone). After the window the
outputs are judged against the plain reference in `port_bench/reference/`.
Each number compared goes to standard error beside its limit, and the last
line of standard output is the result as one JSON object. Without a CUDA
card, or with the JAX package or JAX loaded once the window has closed, the
run prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from port_bench.harness import forbidden_modules, run_cell
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except SystemExit as err:
        print(f"port_bench: {err}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"port_bench: the process holds {', '.join(found)}; the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
