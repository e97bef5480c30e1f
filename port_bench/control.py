"""The readings that the limits of `correct` are set from, on the card.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--fault-seeds 21 22 23] [--seconds 2] [--out readings.jsonl]

For each seed, in one process: the cell's program is set up as a run sets
it up, serves its traffic for `--seconds` (test cells; a train cell's
readings come from its set-up steps) and is judged against the reference;
for each control seed, the control is judged too: the reference computed
in the precision next below the configuration's (float8 e4m3 for bfloat16,
TF32 for float32) in the program's place, on the same inputs; for each fault
seed of a train cell, the reference with each of the driver's `FAULTS`
planted in it (half the batch left out; the loss altered where it is
produced, in every inner iteration or from the second on; the optimizer's
state altered). One JSON line a reading: {"seed", "kind": "program" |
"control" | "fault_<name>", the numbers compared}.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import importlib

    import torch

    from port_bench.harness import load_cell, measure

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                    help="train cells: read the faults planted in the reference on these")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    driver = importlib.import_module(f"port_bench.drivers.{cell.workload['driver']}")
    out = open(args.out, "a") if args.out else None
    for seed in dict.fromkeys(args.seeds + args.control_seeds + args.fault_seeds):
        t0 = time.perf_counter()
        run = driver.build(cell, seed, torch.device("cuda"))
        if not run.training:
            measure(run, args.seconds, False)
        run.release()
        lines = []
        if seed in args.seeds:
            lines.append({"seed": seed, "kind": "program", **run.readings()})
        if seed in args.control_seeds:
            lines.append({"seed": seed, "kind": "control", **run.control()})
        if seed in args.fault_seeds and run.training:
            for fault in driver.FAULTS:
                lines.append({"seed": seed, "kind": f"fault_{fault}",
                              **run.readings("f32", fault)})
        for line in lines:
            line["cell"], line["s"] = args.workload, time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
