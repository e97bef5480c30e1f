"""Convert external pose-estimator outputs (SPD / DualPoseNet eval pkls +
MaskRCNN segmentation pkls) into the `test_init_poses/*.json` format the test
loader consumes.

Counterpart of `catre_tpu/tools/prepare_init_results.py`, jax-free: the masks
are run-length encoded by `data/rle.py::binary_mask_to_rle`. The same inputs
give the same JSON.

Behavioral reference: `core/catre/tools/prepare_spd_init_results.py:1-106`
(and the camera25 variant): per-frame results pkls with pred_RTs (scaled
rotations sR), pred_scales (normalized), pred_class_ids, pred_bboxes (yxyx),
pred_scores, gt_handle_visibility; the scaled rotation is factored into
(R, nocs_scale) and the metric size recovered as pred_scale * nocs_scale.

Run:
  python -m catre_tpu_torch.tools.prepare_init_results \
      --pose-dir datasets/NOCS/deformnet_eval/eval_real \
      --seg-dir datasets/NOCS/deformnet_eval/mrcnn_results/real_test \
      --out datasets/NOCS/test_init_poses/init_pose_spd_nocs_real.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import pickle

import numpy as np

from ..data.rle import binary_mask_to_rle


def convert_frame(preds: dict, masks: np.ndarray) -> list:
    """One frame's predictions -> init-pose entries."""
    out = []
    bboxes = np.asarray(preds["pred_bboxes"])
    scores = np.asarray(preds["pred_scores"])
    poses = np.asarray(preds["pred_RTs"])[:, :3].copy()
    pred_scales = np.asarray(preds["pred_scales"])
    class_ids = np.asarray(preds["pred_class_ids"])
    mug_handles = np.asarray(preds.get("gt_handle_visibility", np.ones(len(class_ids))))
    assert masks.shape[2] == len(class_ids), (masks.shape, len(class_ids))

    for i, class_id in enumerate(class_ids):
        pose = poses[i]
        # factor the NOCS scale out of the scaled rotation sR
        R = pose[:3, :3]
        nocs_scale = float(np.cbrt(np.linalg.det(R)))
        abs_scale = pred_scales[i] * nocs_scale
        pose = pose.copy()
        pose[:3, :3] = R / nocs_scale
        mask_rle = binary_mask_to_rle(masks[:, :, i].astype(bool))
        y1, x1, y2, x2 = np.asarray(bboxes[i]).tolist()
        out.append({
            "obj_id": int(class_id),
            "pose_est": pose.tolist(),
            "scale_est": np.asarray(abs_scale).tolist(),
            "bbox_est": [x1, y1, x2, y2],
            "score": float(scores[i]),
            "mug_handle": int(mug_handles[i]),
            "segmentation": mask_rle,
        })
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="prepare init-pose json")
    parser.add_argument("--pose-dir", required=True)
    parser.add_argument("--seg-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--seg-prefix", default="results_test")
    args = parser.parse_args(argv)

    results = {}
    for pose_path in sorted(glob.glob(osp.join(args.pose_dir, "results*.pkl"))):
        with open(pose_path, "rb") as f:
            preds = pickle.load(f)
        scene_id, im_id = osp.basename(pose_path).split(".")[0].split("_")[-2:]
        scene_im_id = f"scene_{scene_id}/{im_id}"
        seg_path = osp.join(args.seg_dir, f"{args.seg_prefix}_scene_{scene_id}_{im_id}.pkl")
        with open(seg_path, "rb") as f:
            masks = pickle.load(f)["masks"].astype(int)
        results[scene_im_id] = convert_frame(preds, masks)

    os.makedirs(osp.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} frames to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
