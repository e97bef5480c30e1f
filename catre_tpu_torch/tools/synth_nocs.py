"""Synthetic NOCS-format dataset generator (REAL275-shaped).

Writes a fully on-disk split in the exact layout `data/nocs.NOCSDataset`
consumes (`real_train/scene_N/XXXX_{depth,mask,color}.png` + `_label.pkl` +
`<split>_list_all.txt`), so the complete input pipeline — list files, label
pkls, RLE masks, md5 dict cache, decode, device ball-crop — runs unmodified
against data of the reference's shape (640x480 u16 depth, multiple oriented
instances per frame, per-instance metric scales from the shipped abs-scale
asset pickle). Used by the flagship training soak (docs/TRAINRUN.md) and
available as a CLI:

    python -m catre_tpu_torch.tools.synth_nocs --out DIR --split real_train \
        --frames 2000 [--objs 6] [--seed 0] [--no-mugs]

Depth is rendered analytically: per-pixel ray / oriented-box intersection
(slab method) over the projected window — exact, hole-free u16 millimeter
depth like the REAL275 sensor files (label format per reference
`preprocess/pose_data.py:18-54`; label keys as read by `datasets/nocs.py:168-242`).

A jax-free copy of `catre_tpu/tools/synth_nocs.py`: the PNGs are written by
`data/png.py::write_png` in place of `cv2.imwrite` and decode to the same
pixels, the mean shapes and abs scales come from the port's `data/assets.py`,
and the renderer stays numpy (one 480 x 640 frame at a time). The same seed
gives the JAX tool's frames, labels and list file.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..data import assets, meta, png


def render_obb_depth(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                     extents: np.ndarray, h: int, w: int):
    """Exact depth of an oriented box (center t, rotation R, full extents)
    via per-pixel ray/slab intersection. Returns (depth_m (h, w) f32 with 0
    outside, bbox yxyx) — depth is z-distance (pinhole z), matching the
    backprojection convention."""
    half = np.asarray(extents, np.float64) / 2.0
    # project the 8 corners to bound the pixel window
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64) * half
    cam = corners @ R.T + t
    uv = cam @ K.T
    uv = uv[:, :2] / uv[:, 2:3]
    x1 = max(int(np.floor(uv[:, 0].min())) - 1, 0)
    x2 = min(int(np.ceil(uv[:, 0].max())) + 1, w - 1)
    y1 = max(int(np.floor(uv[:, 1].min())) - 1, 0)
    y2 = min(int(np.ceil(uv[:, 1].max())) + 1, h - 1)
    depth = np.zeros((h, w), np.float32)
    if x2 <= x1 or y2 <= y1:
        return depth, None

    us, vs = np.meshgrid(np.arange(x1, x2 + 1), np.arange(y1, y2 + 1))
    # camera-frame ray directions with dz=1 -> hit parameter == pinhole depth
    d = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                  np.ones_like(us, np.float64)], axis=-1)
    # box frame: origin at center, axes = R columns
    o_b = -R.T @ t                      # ray origin (camera center) in box frame
    d_b = d @ R                         # (win, 3) directions in box frame
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o_b) / d_b
        t2 = (half - o_b) / d_b
    tmin = np.minimum(t1, t2).max(axis=-1)
    tmax = np.maximum(t1, t2).min(axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    z = np.where(hit, np.maximum(tmin, 0.0), 0.0).astype(np.float32)
    depth[vs[hit], us[hit]] = z[hit]

    ys, xs = np.nonzero(depth)
    if len(ys) == 0:
        return depth, None
    bbox = [int(ys.min()), int(xs.min()), int(ys.max()), int(xs.max())]  # yxyx
    return depth, bbox


def render_points_depth(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                        pts_obj: np.ndarray, h: int, w: int, splat: int = 5):
    """Depth of a posed object POINT CLOUD via z-buffered square splats.

    Used for category-mean-shape instances: rotation refinement is only
    learnable when the observed cloud matches the prior keypoints' shape
    (a box observation vs a bottle prior leaves ΔR unobservable from the
    input — 180-degree box flips produce identical clouds — and a model
    trained on that data correctly learns the identity rotation delta;
    measured in round 3, docs/TRAINRUN.md). Splat holes are realistic —
    the ball-crop samples mask∧depth>0 pixels.
    """
    cam = pts_obj @ R.T + t
    z = cam[:, 2]
    keep = z > 1e-3
    cam = cam[keep]
    z = z[keep]
    u = np.round(cam[:, 0] / z * K[0, 0] + K[0, 2]).astype(int)
    v = np.round(cam[:, 1] / z * K[1, 1] + K[1, 2]).astype(int)
    depth = np.full((h, w), np.inf, np.float32)
    half = splat // 2
    order = np.argsort(-z)  # nearer points splat last (win ties cleanly)
    for du in range(-half, half + 1):
        for dv in range(-half, half + 1):
            uu = np.clip(u[order] + du, 0, w - 1)
            vv = np.clip(v[order] + dv, 0, h - 1)
            # per-pixel min depth: nearer (later) writes overwrite
            cur = depth[vv, uu]
            zi = z[order].astype(np.float32)
            depth[vv, uu] = np.where(zi < cur, zi, cur)
    depth[~np.isfinite(depth)] = 0.0
    ys, xs = np.nonzero(depth)
    if len(ys) == 0:
        return depth, None
    bbox = [int(ys.min()), int(xs.min()), int(ys.max()), int(xs.max())]
    return depth, bbox


def _pick_instances(no_mugs: bool):
    """Instance name per category from the shipped abs-scale pickle (so the
    loaded gt `scale` matches the rendered box exactly); synthesized
    fallbacks when the asset pickle is absent."""
    objs = [o for o in meta.OBJECTS if not (no_mugs and o == "mug")]
    try:
        scales_dict = assets.load_abs_scales()
    except FileNotFoundError:
        scales_dict = {}
    rng = np.random.default_rng(12345)
    table = {}
    for obj in objs:
        named = sorted(k for k in scales_dict if k.startswith(obj))
        if named:
            table[obj] = [(n, np.asarray(scales_dict[n], np.float32)) for n in named]
        else:
            table[obj] = [(f"{obj}_synth_{i}_norm",
                           (np.asarray(meta.MEAN_SCALE[obj], np.float32)
                            * rng.uniform(0.8, 1.2, 3).astype(np.float32)))
                          for i in range(3)]
    return objs, table


def generate_split(root: str, split: str = "real_train", n_frames: int = 200,
                   n_objs: int = 6, seed: int = 0, no_mugs: bool | None = None,
                   frames_per_scene: int = 100, shape: str = "mean") -> str:
    """Write n_frames synthetic frames under root/<split>/scene_K/. Returns
    the image_root (= root). no_mugs defaults to True for train real splits
    (the real mug-handle visibility pickle cannot cover synthetic scenes,
    `datasets/nocs.py:104-107`).

    shape="mean" (default): instances are the CATEGORY MEAN SHAPES scaled to
    the instance extents — observations match the refiner's prior keypoints
    like real data does, so rotation refinement is learnable (see
    render_points_depth). shape="box": exact ray-traced oriented boxes
    (hole-free depth; rotationally ambiguous — good for pipeline/throughput
    benchmarks, NOT for training rotation)."""
    if no_mugs is None:
        no_mugs = "train" in split
    objs, inst_table = _pick_instances(no_mugs)
    mean_shapes = None
    if shape == "mean":
        mean_shapes = assets.mean_shape_array()  # (6, 1024, 3) normalized
    h, w = meta.IM_HEIGHT, meta.IM_WIDTH
    K = np.asarray(meta.REAL_INTRINSICS if "real" in split else meta.CMRA_INTRINSICS,
                   np.float64)
    rng = np.random.default_rng(seed)
    lines = []
    for f in range(n_frames):
        scene = f // frames_per_scene + 1
        im_id = f % frames_per_scene
        sdir = osp.join(root, split, f"scene_{scene}")
        os.makedirs(sdir, exist_ok=True)
        base = osp.join(sdir, f"{im_id:04d}")

        zbuf = np.zeros((h, w), np.float32)
        mask = np.zeros((h, w), np.uint8)
        label = {"instance_ids": [], "class_ids": [], "model_list": [],
                 "rotations": [], "translations": [], "scales": [], "bboxes": []}
        # lay objects on a jittered grid so most frames keep all instances
        cells = rng.permutation(8)[:n_objs]
        for j, cell in enumerate(cells):
            obj = objs[int(rng.integers(len(objs)))]
            inst_name, extents = inst_table[obj][int(rng.integers(len(inst_table[obj])))]
            # uniform SO(3) rotation via normalized gaussian quaternion
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            qw, qx, qy, qz = q
            R = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ], np.float64)
            r, c = divmod(int(cell), 4)
            cy = 120 + 240 * r + rng.integers(-20, 21)
            cx = 80 + 160 * c + rng.integers(-20, 21)
            z = float(rng.uniform(0.7, 1.4))
            t = np.array([(cx - K[0, 2]) / K[0, 0] * z,
                          (cy - K[1, 2]) / K[1, 1] * z, z], np.float64)
            if mean_shapes is not None:
                cat0 = meta.OBJ2ID[obj] - 1
                pts_obj = mean_shapes[cat0].astype(np.float64) * extents
                depth_j, bbox = render_points_depth(K, R, t, pts_obj, h, w)
            else:
                depth_j, bbox = render_obb_depth(K, R, t, extents, h, w)
            if bbox is None:
                continue
            vis = depth_j > 0
            nearer = vis & ((zbuf == 0) | (depth_j < zbuf))
            if nearer.sum() < 64:  # fully occluded: drop the instance
                continue
            zbuf[nearer] = depth_j[nearer]
            mask[nearer] = j + 1
            label["instance_ids"].append(j + 1)
            label["class_ids"].append(meta.OBJ2ID[obj])
            label["model_list"].append(inst_name)
            label["rotations"].append(R.astype(np.float32))
            label["translations"].append(t.astype(np.float32))
            # nocs_scale: norm of the metric extents (reference convention,
            # abs scale itself comes from the asset pickle at load time)
            label["scales"].append(float(np.linalg.norm(extents)))
            ys, xs = np.nonzero(mask == j + 1)
            label["bboxes"].append([int(ys.min()), int(xs.min()),
                                    int(ys.max()), int(xs.max())])
        if not label["instance_ids"]:
            continue
        png.write_png(base + "_depth.png", np.round(zbuf * 1000.0).astype(np.uint16))
        png.write_png(base + "_mask.png", mask)
        png.write_png(base + "_color.png", np.zeros((h, w, 3), np.uint8))
        with open(base + "_label.pkl", "wb") as fh:
            pickle.dump(label, fh)
        lines.append(f"{split}/scene_{scene}/{im_id:04d}")

    with open(osp.join(root, f"{split}_list_all.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return root


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="real_train")
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--objs", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-mugs", action="store_true", default=None)
    p.add_argument("--shape", default="mean", choices=["mean", "box"])
    args = p.parse_args(argv)
    generate_split(args.out, split=args.split, n_frames=args.frames,
                   n_objs=args.objs, seed=args.seed, no_mugs=args.no_mugs,
                   shape=args.shape)
    print(f"wrote {args.frames} frames to {args.out}/{args.split}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
