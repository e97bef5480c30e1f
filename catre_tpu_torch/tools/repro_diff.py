"""Diff a repro run's final-iteration summary against reference-regenerated
numbers within the 0.5 pt parity budget (BASELINE.md; reference tables are
printed by `catre_custom_evaluator.py:276-325`).

A stdlib copy of `catre_tpu/tools/repro_diff.py`; it reads the
`metrics_tab_iter<i>.txt` that the port's evaluator dumps as the JAX one does.

    python -m catre_tpu_torch.tools.repro_diff OUT_DIR ref_summary.json [--budget 0.5]

ref_summary.json: {"IoU75": 43.6, "re5te2": ...} — any subset of the metric
names in the dumped table's first column (Avg(6) column is compared).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys


def load_table_summary(out_dir: str, refine_i: int = 4) -> dict:
    """Parse metrics_tab_iter<i>.txt (evaluator._dump_table layout: header
    row of object names + Avg(6); one row per metric) into {metric: avg}."""
    path = osp.join(out_dir, f"metrics_tab_iter{refine_i}.txt")
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    header = rows[0]
    assert header[-1] == "Avg(6)", header
    return {r[0]: float(r[-1]) for r in rows[1:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("ref_json")
    p.add_argument("--budget", type=float, default=0.5)
    p.add_argument("--iter", type=int, default=4)
    args = p.parse_args(argv)

    got = load_table_summary(args.out_dir, args.iter)
    with open(args.ref_json) as f:
        ref = json.load(f)
    bad = []
    for k, want in ref.items():
        if k not in got:
            print(f"  [skip] {k}: not in table")
            continue
        delta = got[k] - float(want)
        ok = abs(delta) <= args.budget
        print(f"  [{'ok' if ok else 'FAIL'}] {k}: ours {got[k]:.2f} "
              f"ref {float(want):.2f} (delta {delta:+.2f})")
        if not ok:
            bad.append(k)
    if bad:
        print(f"parity FAILED for {bad} (budget {args.budget} pt)", file=sys.stderr)
        return 1
    print("parity OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
