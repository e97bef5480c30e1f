"""Summarize a training run's metrics.json into the docs/TRAINRUN.md tables.

    python -m catre_tpu_torch.tools.trainrun_report OUTPUT_DIR [--points 12]

Reads the JSONWriter stream (`utils/events.py`) and prints a markdown table
of loss/error milestones plus steady-state timing (obj/s from the `time`
scalar and the instance batch size). A stdlib copy of
`catre_tpu/tools/trainrun_report.py`: the port's `do_train` writes the same
stream and the same `log.txt` lines.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp


def load_metrics(out_dir: str) -> list:
    recs = []
    with open(osp.join(out_dir, "metrics.json")) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    # resumed runs append; keep the LAST record per iteration
    by_iter = {}
    for r in recs:
        by_iter[r["iteration"]] = r
    return [by_iter[i] for i in sorted(by_iter)]


def milestone_table(recs: list, points: int, keys: tuple) -> str:
    idx = [int(round(i * (len(recs) - 1) / max(points - 1, 1)))
           for i in range(points)]
    rows = ["| iter | " + " | ".join(keys) + " |",
            "|---|" + "---|" * len(keys)]
    for i in idx:
        r = recs[i]
        cells = [f"{r.get(k, float('nan')):.4g}" for k in keys]
        rows.append(f"| {r['iteration']} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def steady_state_from_log(log_path: str, batch_objs: int):
    """Wall rate from the MetricPrinter's timestamped `iter N/...` lines
    (the per-iteration `time` scalar is async-dispatch-distorted: the host
    runs ahead of the device between metric syncs)."""
    import datetime
    import re

    pts = []
    pat = re.compile(r"^(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}),\d+ .*iter (\d+)/")
    with open(log_path, errors="replace") as f:
        for line in f:
            m = pat.match(line)
            if m:
                t = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")
                pts.append((t, int(m.group(2))))
    if len(pts) < 3:
        return None
    # median of per-interval rates over the second half (skips compile)
    half = pts[len(pts) // 2:]
    rates = []
    for (t0, i0), (t1, i1) in zip(half, half[1:]):
        dt = (t1 - t0).total_seconds()
        if i1 > i0 and dt > 0:
            rates.append(dt / (i1 - i0))
    if not rates:
        return None
    rates.sort()
    med = rates[len(rates) // 2]
    return med, batch_objs / med


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--points", type=int, default=12)
    p.add_argument("--batch-objs", type=int, default=512)
    p.add_argument("--log", default="", help="driver log with timestamped "
                   "MetricPrinter lines for wall-rate extraction")
    args = p.parse_args(argv)

    recs = load_metrics(args.out_dir)
    if not recs:
        print("no metrics records")
        return 1
    last = recs[-1]
    final_iter = max(int(k.split("/")[0][4:]) for k in last
                     if k.startswith("iter") and "/" in k)
    keys = ("loss_total", f"iter{final_iter}/error_R", f"iter{final_iter}/error_t", "lr")
    keys = tuple(k for k in keys if k in last)
    print(f"records: {len(recs)} (iterations {recs[0]['iteration']}"
          f"..{last['iteration']})\n")
    print(milestone_table(recs, args.points, keys))
    if args.log:
        ss = steady_state_from_log(args.log, args.batch_objs)
        if ss:
            print(f"\nsteady-state: {ss[0]*1000:.0f} ms/iter (median interval "
                  f"rate, 2nd half) = {ss[1]:.0f} obj/s at B={args.batch_objs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
