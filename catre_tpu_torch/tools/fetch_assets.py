"""Asset checker / runbook for scoring the released checkpoint.

The released CATRE checkpoint and the NOCS REAL275 frames are distributed
out-of-band (reference `README.md:36-46` points at the authors' OneDrive and
the NOCS release). This tool downloads nothing: it checks the expected
on-disk layout under the port's data root (`data/meta.py`: CATRE_DATA_ROOT,
else `datasets/` of the checkout) and prints what is missing and where to put
it; with everything in place it prints the `main --eval-only` command that
scores the checkpoint. A stdlib copy of `catre_tpu/tools/fetch_assets.py`.

Usage:
    python -m catre_tpu_torch.tools.fetch_assets [--data-root DIR]
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

from ..config.build import FLAGSHIP_CONFIG
from ..data import meta

CKPT_NAME = "model_final_wo_optim-82cf930e.pth"

EXPECTED = [
    # (relative path, what it is, where it comes from)
    (osp.join("checkpoints", CKPT_NAME),
     "released CATRE weights (md5 prefix 82cf930e)",
     "reference README.md:42 (authors' OneDrive link)"),
    (osp.join("NOCS", "REAL", "real_test_list_all.txt"),
     "REAL275 test frame list",
     "NOCS release (real_test.zip) / reference datasets/NOCS layout"),
    (osp.join("NOCS", "obj_models", "cr_normed_mean_model_points_spd.pkl"),
     "category mean shapes (1024 pts)",
     "reference datasets/NOCS/obj_models"),
    (osp.join("NOCS", "obj_models", "abs_scale.pkl"),
     "instance metric sizes",
     "reference datasets/NOCS/obj_models"),
    (osp.join("NOCS", "test_init_poses", "init_pose_spd_nocs_real.json"),
     "SPD initial estimates (optional; gt_noise mode works without)",
     "reference datasets/NOCS/test_init_poses"),
]


def check(data_root: str) -> int:
    missing = []
    print(f"checking assets under {data_root}\n")
    for rel, what, src in EXPECTED:
        path = osp.join(data_root, rel)
        ok = osp.isfile(path)
        print(f"  [{'ok' if ok else 'MISSING'}] {rel}  — {what}")
        if not ok:
            missing.append((rel, src))

    # frames need at least one depth+label pair
    lst = osp.join(data_root, "NOCS", "REAL", "real_test_list_all.txt")
    n_frames = 0
    if osp.isfile(lst):
        with open(lst) as f:
            for line in f:
                base = osp.join(data_root, "NOCS", "REAL", line.strip())
                if osp.isfile(base + "_depth.png") and osp.isfile(base + "_label.pkl"):
                    n_frames += 1
        print(f"\n  {n_frames} complete frames (depth+label) found")
        if n_frames == 0:
            missing.append(("NOCS/REAL/real_test/*_depth.png + *_label.pkl",
                            "NOCS release; labels via "
                            "`python -m catre_tpu_torch.tools.pose_data --split real_test`"))

    if not missing:
        print("\nall assets present — run: "
              f"CATRE_DATA_ROOT={data_root} python -m catre_tpu_torch.main --config-file "
              f"{FLAGSHIP_CONFIG} --eval-only "
              f"MODEL.WEIGHTS={osp.join(data_root, 'checkpoints', CKPT_NAME)}")
        return 0
    print("\nmissing assets:")
    for rel, src in missing:
        print(f"  - {rel}\n      source: {src}")
    print(f"\nplace them under {data_root}/ (or set CATRE_DATA_ROOT), then re-run this "
          "tool.")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", default=meta.DATA_ROOT)
    args = ap.parse_args(argv)
    return check(args.data_root)


if __name__ == "__main__":
    sys.exit(main())
