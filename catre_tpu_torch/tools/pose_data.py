"""Offline gt-label generation: per-frame `*_label.pkl` from depth, NOCS
coordinate maps and instance masks.

Counterpart of `catre_tpu/tools/pose_data.py`, jax-free and without OpenCV:
the PNGs are read by `data/png.py::read_png` (depth through
`data/loader.py::load_depth`), which returns what `cv2.imread` returns for
16-bit and 8-bit greyscale and for 8-bit RGB (in BGR order, so the channels
are indexed as the JAX tool indexes them). A mask or coordinate PNG of another
colour type (palette, alpha, 16-bit colour), which `cv2.imread` would
convert, raises `ValueError` naming its format; a coordinate map that is not
8-bit RGB raises too. The PnP labels come from `tools/alignment.py::pnp_pose`
(numpy EPnP with its own RANSAC draws), not `cv2.solvePnPRansac`.

Behavioural reference: `preprocess/pose_data.py`: CAMERA gt by Umeyama
between the NOCS coordinates and the back-projected depth (`:56-166`), REAL
train gt by PnP (`:342-417`), the mug re-centring with mug_meta
(`:393-397`), the image list (`create_img_list`, `:168-188`), the REAL test
gt merged from the NOCS release (`:419-520`).

Run: python -m catre_tpu_torch.tools.pose_data --data-root datasets/NOCS --split real_test
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..data import assets, meta, png
from ..data.loader import decode_coord_map, load_depth
from .alignment import pnp_pose, ransac_umeyama


def backproject_masked(depth: np.ndarray, K: np.ndarray, mask: np.ndarray):
    """(pts (N, 3), (rows, cols)) of the masked pixels with depth
    (`pose_data.py:90-106`)."""
    valid = np.logical_and(mask, depth > 0)
    rows, cols = np.where(valid)
    z = depth[rows, cols]
    x = (cols - K[0, 2]) * z / K[0, 0]
    y = (rows - K[1, 2]) * z / K[1, 1]
    return np.stack([x, y, z], axis=1), (rows, cols)


def align_instance_umeyama(coord: np.ndarray, depth: np.ndarray, mask: np.ndarray,
                           K: np.ndarray, seed: int = 0):
    """CAMERA-style gt: the similarity NOCS -> camera. -> (nocs scale s, R
    (3, 3), t (3,)), or None when degenerate."""
    pts, (rows, cols) = backproject_masked(depth, K, mask)
    if len(pts) < 5:
        return None
    nocs = coord[rows, cols]
    s, R, t, _ = ransac_umeyama(nocs, pts, seed=seed)
    if s is None:
        return None
    return s, R, t


def align_instance_pnp(coord: np.ndarray, mask: np.ndarray, K: np.ndarray, nocs_scale: float):
    """REAL-train-style gt: PnP between the metric NOCS coordinates of every
    mask pixel and the pixels (`pose_data.py:381-389`; no depth). -> (3, 4)
    pose or None."""
    rows, cols = np.where(mask)
    if len(rows) < 6:
        return None
    pts3d = coord[rows, cols] * nocs_scale
    pts2d = np.stack([cols, rows], axis=1).astype(np.float64)
    return pnp_pose(pts3d, pts2d, K)


def _mug_relabel(s, R, t, model_name: str, mug_meta: dict | None):
    """Mug re-centring after the fit (`pose_data.py:393-397, 315-322`):
    t <- t - s R t0, s <- s / s0."""
    if mug_meta is None or model_name not in mug_meta:
        return s, R, t
    t0, s0 = mug_meta[model_name]
    t = t - s * (R @ np.asarray(t0, np.float64))
    return s / float(s0), R, t


def read_frame_meta(base_path: str) -> list:
    """_meta.txt: "<inst_id> <class_id> <model_name>" a line (NOCS format)."""
    metas = []
    with open(base_path + "_meta.txt") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                metas.append((int(parts[0]), int(parts[1]), parts[2]))
    return metas


def read_instance_masks(base_path: str):
    """The (H, W) instance-id image of `<base>_mask.png` (channel R of a
    3-channel one), or None when the file is missing."""
    try:
        mask_full = png.read_png(base_path + "_mask.png")
    except FileNotFoundError:
        return None
    if mask_full.ndim == 3:
        mask_full = mask_full[:, :, 2]
    return mask_full


def _read_coord(base_path: str) -> np.ndarray:
    coord = png.read_png(base_path + "_coord.png")
    if coord.ndim != 3 or coord.dtype != np.uint8:
        raise ValueError(f"{base_path}_coord.png: a NOCS map is 8-bit RGB, not {coord.dtype} "
                         f"{coord.shape}")
    return decode_coord_map(coord)


def process_frame(base_path: str, K: np.ndarray, method: str = "umeyama",
                  mug_meta: dict | None = None,
                  scale_factors: dict | None = None) -> dict | None:
    """One frame's `*_label.pkl` dict from its _depth / _mask / _coord /
    _meta files, or None when no instance is left.

    method="umeyama": the CAMERA-style similarity fit, its scale observable
    (`pose_data.py:56-166`). method="pnp": REAL-train style; PnP does not
    observe the NOCS scale, which comes from `scale_factors` (model ->
    ||abs_scale||, `nocs_scale_factors`, `pose_data.py:347-351`). The mug
    re-centring follows the fit in both (`:315-322, 393-397`)."""
    depth = load_depth(base_path + "_depth.png")
    mask_full = read_instance_masks(base_path)
    if mask_full is None:
        return None
    coord = _read_coord(base_path)

    label = {"instance_ids": [], "class_ids": [], "model_list": [],
             "rotations": [], "translations": [], "scales": [], "bboxes": []}
    for inst_id, class_id, model_name in read_frame_meta(base_path):
        mask = mask_full == inst_id
        if mask.sum() < 30:
            continue
        if method == "umeyama":
            out = align_instance_umeyama(coord, depth, mask, K)
            if out is None:
                continue
            s, R, t = out
        else:
            if not scale_factors or model_name not in scale_factors:
                raise KeyError(f"pnp labeling needs the NOCS scale of {model_name!r} "
                               "(obj_models/abs_scale.pkl; ref pose_data.py:347-351)")
            s = float(scale_factors[model_name])
            pose = align_instance_pnp(coord, mask, K, nocs_scale=s)
            if pose is None:
                continue
            R, t = pose[:, :3].astype(np.float64), pose[:, 3].astype(np.float64)
        s, R, t = _mug_relabel(s, R, t, model_name, mug_meta)

        rows, cols = np.where(mask)
        label["instance_ids"].append(inst_id)
        label["class_ids"].append(class_id)
        label["model_list"].append(model_name)
        label["rotations"].append(np.asarray(R, dtype=np.float32))
        label["translations"].append(np.asarray(t, dtype=np.float32))
        label["scales"].append(float(s))
        label["bboxes"].append([int(rows.min()), int(cols.min()), int(rows.max()),
                                int(cols.max())])
    if not label["instance_ids"]:
        return None
    return label


def merge_test_gts(base_path: str, nocs_gt: dict, model_sizes: dict,
                   mug_meta: dict | None = None) -> dict | None:
    """A REAL-test label from the NOCS release gts (`pose_data.py:419-520`):
    each meta instance matched to a gt of its class whose box is within 5 in
    L1, the handle visibility copied, gt_RTs split into s = cbrt(det), R, t,
    the mug re-centred. Raises AssertionError on an instance without a match or
    two instances on one gt, as the reference does (:497-500).

    nocs_gt: {"gt_class_ids", "gt_bboxes", "gt_RTs", "gt_handle_visibility"};
    model_sizes: model -> (3,) size, `model_sizes_from_points`."""
    mask_full = read_instance_masks(base_path)
    if mask_full is None:
        return None
    insts = []
    for inst_id, class_id, model_name in read_frame_meta(base_path):
        mask = mask_full == inst_id
        if mask.sum() < 30:
            continue
        rows, cols = np.where(mask)
        bbox = np.array([rows.min(), cols.min(), rows.max(), cols.max()])
        insts.append((inst_id, class_id, model_name, bbox))
    if not insts:
        return None

    gt_class_ids = np.asarray(nocs_gt["gt_class_ids"])
    gt_bboxes = np.asarray(nocs_gt["gt_bboxes"])
    gt_sRT = np.asarray(nocs_gt["gt_RTs"])
    gt_handle = np.asarray(nocs_gt["gt_handle_visibility"])

    map_to_nocs = []
    for _, class_id, _, bbox in insts:
        matches = [j for j in range(len(gt_class_ids)) if gt_class_ids[j] == class_id
                   and np.sum(np.abs(bbox - gt_bboxes[j])) <= 5]
        gt_match = matches[0] if matches else -1
        assert gt_match > -1, f"{base_path}: no NOCS gt match for an instance"
        assert gt_match not in map_to_nocs, f"{base_path}: duplicate NOCS match"
        map_to_nocs.append(gt_match)

    n = len(insts)
    label = {
        "instance_ids": [i for i, _, _, _ in insts],
        "class_ids": np.array([c for _, c, _, _ in insts]),
        "model_list": [m for _, _, m, _ in insts],
        "bboxes": np.stack([b for _, _, _, b in insts]),
        "size": np.zeros((n, 3), np.float64),
        "scales": np.zeros(n, np.float32),
        "rotations": np.zeros((n, 3, 3), np.float32),
        "translations": np.zeros((n, 3), np.float32),
        "poses": np.zeros((n, 4, 4), np.float32),
        "handle_visibility": gt_handle[map_to_nocs],
    }
    for i, (_, _, model_name, _) in enumerate(insts):
        label["size"][i] = model_sizes[model_name]
        sRT = gt_sRT[map_to_nocs[i]]
        s = np.cbrt(np.linalg.det(sRT[:3, :3]))
        s, R, t = _mug_relabel(s, sRT[:3, :3] / s, sRT[:3, 3], model_name, mug_meta)
        label["scales"][i] = s
        label["rotations"][i] = R
        label["translations"][i] = t
        pose = np.identity(4, dtype=np.float32)
        pose[:3, :3] = s * R
        pose[:3, 3] = t
        label["poses"][i] = pose
    return label


def model_sizes_from_points(models: dict) -> dict:
    """model -> 2 max |pts| per axis (`pose_data.py:432-437`)."""
    return {k: 2 * np.amax(np.abs(v), axis=0) for k, v in models.items()}


def nocs_scale_factors(scales_dict: dict) -> dict:
    """model -> ||abs_scale|| (`pose_data.py:347-351`)."""
    return {k: float(np.linalg.norm(v)) for k, v in scales_dict.items()}


def create_img_list(split_dir: str, out_path: str) -> list:
    """Write `<split>_list_all.txt` (`pose_data.py:168-188`)."""
    split = osp.basename(split_dir.rstrip("/"))
    lines = []
    for scene in sorted(os.listdir(split_dir)):
        sdir = osp.join(split_dir, scene)
        if not osp.isdir(sdir):
            continue
        for fn in sorted(os.listdir(sdir)):
            if fn.endswith("_color.png"):
                lines.append(f"{split}/{scene}/{fn[: -len('_color.png')]}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="generate gt label pkls")
    parser.add_argument("--data-root", default=meta.NOCS_ROOT)
    parser.add_argument("--split", default="real_test",
                        choices=["real_train", "real_test", "train", "val"])
    parser.add_argument("--method", default="umeyama", choices=["umeyama", "pnp", "test-merge"])
    parser.add_argument("--nocs-results-dir", default="",
                        help="NOCS release result pkls for --method test-merge "
                        "(ref pose_data.py:466-469: results/nocs_results)")
    args = parser.parse_args(argv)

    sub = "REAL" if args.split.startswith("real") else "CAMERA"
    image_root = osp.join(args.data_root, sub)
    split_dir = osp.join(image_root, args.split)
    K = meta.REAL_INTRINSICS if sub == "REAL" else meta.CMRA_INTRINSICS
    try:
        mug_meta = assets.load_mug_meta()
    except FileNotFoundError:
        mug_meta = None
    scale_factors = None
    if args.method == "pnp":
        scale_factors = nocs_scale_factors(assets.load_abs_scales())
    model_sizes = None
    if args.method == "test-merge":
        model_sizes = model_sizes_from_points(
            assets.load_model_points("train" if "train" in args.split else "test"))

    lines = create_img_list(split_dir, osp.join(image_root, f"{args.split}_list_all.txt"))
    n_done = 0
    for rel in lines:
        base = osp.join(image_root, rel)
        if args.method == "test-merge":
            scene, im_id = rel.split("/")[-2], rel.split("/")[-1]
            nocs_path = osp.join(args.nocs_results_dir, args.split,
                                 f"results_test_{scene}_{im_id}.pkl")
            if not osp.isfile(nocs_path):
                continue
            with open(nocs_path, "rb") as f:
                nocs_gt = pickle.load(f)
            label = merge_test_gts(base, nocs_gt, model_sizes, mug_meta=mug_meta)
        else:
            label = process_frame(base, K, method=args.method, mug_meta=mug_meta,
                                  scale_factors=scale_factors)
        if label is None:
            continue
        with open(base + "_label.pkl", "wb") as f:
            pickle.dump(label, f)
        n_done += 1
    print(f"wrote {n_done}/{len(lines)} label files under {split_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
