"""Generate FPS keypoints per instance (`fps_points_spd.pkl`) from the model
point pickles: the asset of the KPS_TYPE='fps' ablation (reference:
`core/catre/tools/nocs/nocs_fps_sample.py`, `ref/nocs.py:160-166`).

Counterpart of `catre_tpu/tools/fps_sample.py` on `ops/sampling.py::
farthest_point_indices`: the instances of one point count go through in one
batched call on `--device` (the card unless `--device cpu`), and the indices
are the JAX tool's.

Run: python -m catre_tpu_torch.tools.fps_sample --split test --num-points 32
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from ..data import assets, meta
from ..ops.sampling import farthest_point_indices


def fps_keypoints(models: dict, num_points: int, device="cuda") -> dict:
    """instance -> {"fps{N}_and_center": (N + 1, 3) f32}: N farthest points
    then the model's centroid as the last row, the nested layout the reference
    reads (`data_loader.py:337-352` drops the centre)."""
    by_count: dict = {}
    for inst, pts in models.items():
        by_count.setdefault(len(pts), []).append(inst)
    out = {}
    for insts in by_count.values():
        pts = np.stack([np.asarray(models[i], np.float32) for i in insts])
        idx = farthest_point_indices(torch.from_numpy(pts).to(device), num_points).cpu().numpy()
        for inst, p, ix in zip(insts, pts, idx):
            out[inst] = {f"fps{num_points}_and_center": np.concatenate(
                [p[ix], p.mean(axis=0, keepdims=True)], axis=0).astype(np.float32)}
    return {inst: out[inst] for inst in models}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="FPS keypoint sampling")
    parser.add_argument("--split", default="test", choices=["train", "test", "both"])
    parser.add_argument("--num-points", type=int, default=32)
    parser.add_argument("--out", default=None, help="default the data root's fps_points_spd.pkl")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    splits = ["train", "test"] if args.split == "both" else [args.split]
    out = {}
    for split in splits:
        out.update(fps_keypoints(assets.load_model_points(split), args.num_points, args.device))
    path = args.out or meta.FPS_POINTS_PATH
    with open(path, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {len(out)} instances x {args.num_points} fps points to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
