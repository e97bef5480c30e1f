"""NOCS REAL275 / CAMERA25 datasets: registration and dataset dicts.

A jax-free copy of `catre_tpu/data/nocs.py`: `NOCSDataset` (:30) with its
md5-keyed dict cache (:98), `load_init_poses_into_dataset` (:281) and the
registry (`register_dataset`, `get_dataset_dicts`, `DEFAULT_SPLITS`,
`register_default_splits`, :338-365). Behavioural reference:
`core/catre/datasets/nocs.py:31-476`, `cmra.py` and
`core/utils/dataset_utils.py:306` (the external init poses of a test run).

Masks are read through `data/png.py`, not OpenCV (the card's host has none);
a 3-channel mask keeps channel 2 of OpenCV's BGR order, as the JAX package
reads it (:176-180). The asset pickles are read only when a real split is
built. The registry also takes any callable that returns records, as the JAX
one does in effect, so a written split can stand under a config's dataset
name. The visual test harness `_vis_main` (:368) draws with `utils/vis.py`
(numpy; the class names OpenCV writes beside the boxes are not rendered).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import os.path as osp
import pickle

import numpy as np

from . import assets, meta, png
from .rle import binary_mask_to_rle

logger = logging.getLogger(__name__)


def _cache_dir() -> str:
    return os.environ.get("CATRE_CACHE_DIR", osp.join(meta.DATA_ROOT, ".cache"))


class NOCSDataset:
    """Builds the dataset dicts of one split. Split names follow the
    reference (`nocs.py:311-476`): `nocs_train_real`, `nocs_test_real`,
    `nocs_train_cmra`, `nocs_val_cmra`, and per-object variants such as
    `nocs_test_real_bottle`."""

    def __init__(self, name: str, objs=None, with_masks: bool = True,
                 with_depth: bool = True, with_coord: bool = False,
                 filter_invalid: bool = True, use_cache: bool = True,
                 image_root: str | None = None):
        self.name = name
        self.objs = list(objs) if objs is not None else list(meta.OBJECTS)
        self.with_masks = with_masks
        self.with_depth = with_depth
        self.with_coord = with_coord or ("train" in name)
        self.filter_invalid = filter_invalid
        self.use_cache = use_cache
        if "real" in name:
            self.image_root = image_root or osp.join(meta.NOCS_ROOT, "REAL")
            self.split = "real_train" if "train" in name else "real_test"
            self.cam = meta.REAL_INTRINSICS
            self.img_type = "real"
        else:  # cmra (CAMERA25 synthetic)
            self.image_root = image_root or osp.join(meta.NOCS_ROOT, "CAMERA")
            self.split = "train" if "train" in name else "val"
            self.cam = meta.CMRA_INTRINSICS
            self.img_type = "syn"
        self.height, self.width = meta.IM_HEIGHT, meta.IM_WIDTH
        self.cat_ids = [meta.OBJ2ID[obj] for obj in self.objs]
        self.catid2name = {meta.OBJ2ID[obj]: obj for obj in self.objs}
        # 0-based contiguous labels in objs order (the reference's cat2label)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}

    # ---- image list
    def _image_list_path(self) -> str:
        if "part2" in self.name:
            part2 = osp.join(self.image_root, f"{self.split}_list_part2.txt")
            if osp.exists(part2):
                return part2
        return osp.join(self.image_root, f"{self.split}_list_all.txt")

    def _list_images(self) -> list:
        path = self._image_list_path()
        if osp.exists(path):
            with open(path) as f:
                lines = sorted(x.strip() for x in f if x.strip())
            if "part2" in self.name and path.endswith("_list_all.txt"):
                lines = lines[len(lines) // 2:]  # the second half
            return lines
        # no list: scan <split>/scene_x/NNNN_color.png
        split_dir = osp.join(self.image_root, self.split)
        out = []
        if not osp.isdir(split_dir):
            return out
        for scene in sorted(os.listdir(split_dir)):
            sdir = osp.join(split_dir, scene)
            if not osp.isdir(sdir):
                continue
            for fn in sorted(os.listdir(sdir)):
                if fn.endswith("_color.png"):
                    out.append(f"{self.split}/{scene}/{fn[:-len('_color.png')]}")
        return out

    # ---- cache
    def _cache_path(self) -> str:
        hashed = hashlib.md5(
            f"{self.name}|{self.objs}|{self.with_masks}|{self.with_depth}|"
            f"{self.with_coord}|{self.filter_invalid}|{self.image_root}".encode()
        ).hexdigest()
        return osp.join(_cache_dir(), f"dataset_dicts_{self.name}_{hashed}.pkl")

    def __call__(self) -> list:
        cache_path = self._cache_path()
        if self.use_cache and osp.exists(cache_path):
            logger.info("load cached dataset dicts from %s", cache_path)
            with open(cache_path, "rb") as f:
                return pickle.load(f)
        dicts = self._build()
        if self.use_cache and dicts:
            os.makedirs(osp.dirname(cache_path), exist_ok=True)
            with open(cache_path, "wb") as f:
                pickle.dump(dicts, f)
        return dicts

    @staticmethod
    def get_abs_scale(model_pts: np.ndarray, nocs_scale: float, obj_name: str) -> np.ndarray:
        """CAMERA metric size from normalized model extents (`cmra.py:346-364`;
        the mug's x extent symmetrized)."""
        if obj_name == "mug":
            lx = 2 * max(model_pts[:, 0].max(), -model_pts[:, 0].min())
        else:
            lx = model_pts[:, 0].max() - model_pts[:, 0].min()
        ly = model_pts[:, 1].max() - model_pts[:, 1].min()
        lz = model_pts[:, 2].max() - model_pts[:, 2].min()
        return np.array([lx, ly, lz], dtype=np.float32) * nocs_scale

    @staticmethod
    def _read_mask(path: str):
        """The instance-id mask, or None when the file is unreadable; a
        3-channel file gives channel 2 of OpenCV's BGR order."""
        try:
            mask = png.read_png(path)
        except (OSError, ValueError):
            return None
        return mask[:, :, 2] if mask.ndim == 3 else mask

    def _build(self) -> list:
        scales_dict = assets.load_abs_scales()
        try:
            models_dict = assets.load_model_points("train" if "train" in self.name else "test")
        except FileNotFoundError:
            models_dict = {}
        mug_handle_dict = None
        if "train" in self.name and "real" in self.name:
            try:
                mug_handle_dict = assets.load_mug_handle()
            except FileNotFoundError:
                mug_handle_dict = None

        records = []
        n_bad_box = n_bad_seg = 0
        for split_scene_im_id in self._list_images():
            parts = split_scene_im_id.split("/")
            split, scene_id, im_id = parts[-3], parts[-2], parts[-1]
            scene_im_id = f"{scene_id}/{im_id}"
            base = osp.join(self.image_root, split_scene_im_id)
            label_path = base + "_label.pkl"
            if not os.access(label_path, os.R_OK):
                continue
            with open(label_path, "rb") as f:
                gt = pickle.load(f)

            record = {
                "dataset_name": self.name,
                "file_name": base + "_color.png",
                "height": self.height,
                "width": self.width,
                "scene_im_id": scene_im_id,
                "cam": self.cam.copy(),
                "img_type": self.img_type,
            }
            if self.with_depth:
                record["depth_file"] = base + "_depth.png"
            if self.with_coord:
                record["coord_file"] = base + "_coord.png"
            mask_path = base + "_mask.png"
            mask_full = None
            if self.with_masks and os.access(mask_path, os.R_OK):
                mask_full = self._read_mask(mask_path)

            insts = []
            for idx, inst_id in enumerate(gt["instance_ids"]):
                class_id = int(gt["class_ids"][idx])
                if class_id not in self.cat_ids:
                    continue
                obj_name = self.catid2name[class_id]
                inst_name = gt["model_list"][idx]
                if obj_name == "mug" and mug_handle_dict is not None:
                    mug_handle = mug_handle_dict[f"{scene_id}_res"][int(im_id)]
                else:
                    mug_handle = 1
                R = np.asarray(gt["rotations"][idx], dtype=np.float32)
                trans = np.asarray(gt["translations"][idx], dtype=np.float32)
                nocs_scale = gt["scales"][idx]
                abs_scale = scales_dict.get(inst_name)
                if abs_scale is None:
                    # CAMERA instances: metric size from the normalized model's
                    # extents x nocs_scale (`cmra.py:228,346-364`)
                    if inst_name in models_dict:
                        abs_scale = self.get_abs_scale(models_dict[inst_name], float(nocs_scale),
                                                       obj_name)
                    else:
                        # last resort: an isotropic cube of the nocs diagonal
                        abs_scale = np.full(3, float(nocs_scale) / np.sqrt(3), dtype=np.float32)

                y1, x1, y2, x2 = gt["bboxes"][idx]
                bbox = [float(x1), float(y1), float(x2), float(y2)]
                if self.filter_invalid and ((bbox[2] - bbox[0]) <= 1 or (bbox[3] - bbox[1]) <= 1):
                    n_bad_box += 1
                    continue
                inst = {
                    # the global 0-based label (index into meta.OBJECTS), also for
                    # per-object splits, as the JAX package keeps it
                    "category_id": meta.OBJECTS.index(obj_name),
                    "inst_name": inst_name,
                    "inst_id": int(inst_id),
                    "bbox": bbox,
                    "pose": np.hstack([R, trans.reshape(3, 1)]).astype(np.float32),
                    "trans": trans,
                    "scale": np.asarray(abs_scale, dtype=np.float32),
                    "nocs_scale": nocs_scale,
                    "mug_handle": int(mug_handle),
                }
                if mask_full is not None:
                    m = mask_full == inst_id
                    if self.filter_invalid and m.sum() < 30:
                        n_bad_seg += 1
                        continue
                    inst["segmentation"] = binary_mask_to_rle(m)
                insts.append(inst)
            if not insts:
                continue
            record["annotations"] = insts
            records.append(record)
        if n_bad_box:
            logger.warning("filtered %d instances without valid box", n_bad_box)
        if n_bad_seg:
            logger.warning("filtered %d instances without valid segmentation", n_bad_seg)
        return records


# ---- init poses of a test run

def load_init_poses_into_dataset(dataset_dicts: list, init_pose_file: str, objs=None,
                                 score_thr: float = 0.0, train_objs=None) -> list:
    """Replace each test record's annotations by the detections of an init
    pose JSON (scene_im_id -> [{obj_id, pose_est, scale_est, score, ...}]),
    per class in `objs` order and by falling score, those below `score_thr`
    dropped (`load_catre_init_into_dataset`,
    `core/utils/dataset_utils.py:306-388`)."""
    objs = list(objs) if objs is not None else list(meta.OBJECTS)
    with open(init_pose_file) as f:
        init_det_poses = json.load(f)
    for record in dataset_dicts:
        scene_im_id = record["scene_im_id"]
        if scene_im_id not in init_det_poses:
            logger.warning("no init pose detections found in %s", scene_im_id)
            record["annotations"] = []
            continue
        obj_annotations = {obj: [] for obj in objs}
        for det in init_det_poses[scene_im_id]:
            score = det.get("score", 1.0)
            if score < score_thr:
                continue
            obj_name = meta.ID2OBJ[det["obj_id"]]
            if obj_name not in objs:
                continue
            if train_objs is not None and obj_name not in train_objs:
                continue
            inst = {
                "category_id": meta.OBJECTS.index(obj_name),
                "pose_est": np.array(det["pose_est"], dtype=np.float32).reshape(3, 4),
                "scale_est": np.array(det["scale_est"], dtype=np.float32),
                "obj_name": obj_name,
                "mug_handle": det.get("mug_handle", 1),
                "score": score,
                "time": det.get("time", 0.0),
            }
            if "bbox_est" in det:
                inst["bbox_est"] = det["bbox_est"]
            if "segmentation" in det:
                inst["segmentation"] = det["segmentation"]
            obj_annotations[obj_name].append(inst)
        annotations = []
        for obj in objs:
            annotations.extend(sorted(obj_annotations[obj], key=lambda a: a["score"],
                                      reverse=True))
        record["annotations"] = annotations
    return dataset_dicts


# ---- registry

_DATASET_REGISTRY: dict = {}


def register_dataset(name: str, fn=None, **kwargs) -> None:
    """Register `name`: `fn`, any callable that returns the records, or else
    a `NOCSDataset(name, **kwargs)`."""
    _DATASET_REGISTRY[name] = fn if fn is not None else NOCSDataset(name, **kwargs)


def get_dataset_dicts(name: str, **kwargs) -> list:
    if name not in _DATASET_REGISTRY:
        register_dataset(name, **kwargs)
    return _DATASET_REGISTRY[name]()


# the default splits of `SPLITS_NOCS` (`nocs.py:311-374`, `cmra.py:298`)
DEFAULT_SPLITS = [
    "nocs_train_real", "nocs_test_real", "nocs_train_cmra", "nocs_val_cmra",
    "nocs_train_cmra_part2",
] + [f"nocs_test_real_{obj}" for obj in meta.OBJECTS] \
  + [f"nocs_train_real_{obj}" for obj in meta.OBJECTS]


def register_default_splits() -> None:
    for name in DEFAULT_SPLITS:
        if name in _DATASET_REGISTRY:
            continue
        objs = None
        for obj in meta.OBJECTS:
            if name.endswith(f"_{obj}"):
                objs = [obj]
        register_dataset(name, objs=objs)


# ---- visual test harness

def _vis_main(argv=None) -> int:
    """Render a few frames of a split for inspection (the reference's `python
    -m core.catre.datasets.nocs <name>`, `datasets/nocs.py:479-550`): per
    frame one PNG of four panels, the colour image, masks and boxes, the
    projected 3D boxes and the depth as a heat map.

    Usage: python -m catre_tpu_torch.data.nocs <dataset_name> [--num N] [--skip S] [--out DIR]
    """
    import argparse

    from ..utils.vis import draw_line, draw_projected_box3d, grid_show, heatmap
    from .loader import load_depth, mask_from_annotation

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="render dataset frames for manual inspection")
    ap.add_argument("name", help="registered split, e.g. nocs_test_real")
    ap.add_argument("--num", type=int, default=2)
    ap.add_argument("--skip", type=int, default=0, help="frames to skip first")
    ap.add_argument("--out", default="output/dataset_vis")
    args = ap.parse_args(argv)

    register_default_splits()
    dicts = get_dataset_dicts(args.name)
    print(f"{args.name}: {len(dicts)} frames")
    os.makedirs(args.out, exist_ok=True)
    for rec in dicts[args.skip:args.skip + args.num]:
        h, w = rec["height"], rec["width"]
        try:
            img = png.read_png(rec.get("file_name", ""))
            img = img if img.ndim == 3 else np.zeros((h, w, 3), np.uint8)
        except (OSError, ValueError):
            img = np.zeros((h, w, 3), np.uint8)
        try:
            depth = load_depth(rec["depth_file"])
        except (FileNotFoundError, KeyError):
            depth = np.zeros((h, w), np.float32)
        vis, vis3d = img.copy(), img.copy()
        K = np.asarray(rec["cam"])
        for anno in rec.get("annotations", []):
            mask = mask_from_annotation(anno, h, w)
            green = vis[..., 1]          # tinted as cv2.addWeighted(vis, 1, (0, 180, 0), 0.5)
            green[mask] = np.minimum(green[mask].astype(np.int32) + 90, 255)
            if anno.get("bbox") is not None:
                x1, y1, x2, y2 = [float(v) for v in anno["bbox"]]
                for p0, p1 in (((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
                               ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1))):
                    draw_line(vis, p0, p1, (0, 0, 255))
            if "pose" in anno:
                vis3d = draw_projected_box3d(vis3d, np.asarray(anno.get("scale", np.ones(3))),
                                             np.asarray(anno["pose"]), K)
        path = osp.join(args.out, rec["scene_im_id"].replace("/", "_") + ".png")
        grid_show([img[:, :, ::-1], vis[:, :, ::-1], vis3d[:, :, ::-1],
                   heatmap(depth, to_rgb=True)],
                  ["img", "mask+bbox", "projected 3D box", "depth"], row=2, col=2, save_path=path)
        print("wrote", path)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_vis_main())
