"""Loaders for the NOCS asset pickles (mean shapes, model points, abs scales,
mug metadata, FPS keypoints) under `meta.MODEL_DIR`.

A jax-free copy of `catre_tpu/data/assets.py`, for a host that has the
pickles. `CATRELoader` takes the mean-shape table as its `mean_points`
argument and reads it here only when given none; a missing pickle raises
`FileNotFoundError` with its path."""

from __future__ import annotations

import os.path as osp
import pickle
from functools import lru_cache

import numpy as np

from . import meta


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


@lru_cache(maxsize=None)
def load_mean_shapes(path: str = meta.CR_MEAN_MODEL_PATH) -> dict:
    """category -> (1024, 3) float32 mean-shape points."""
    d = _load_pickle(path)
    return {k: np.asarray(v, dtype=np.float32) for k, v in d.items()}


def mean_shape_array(path: str = meta.CR_MEAN_MODEL_PATH) -> np.ndarray:
    """(6, 1024, 3) mean shapes indexed by 0-based category id."""
    shapes = load_mean_shapes(path)
    return np.stack([shapes[meta.ID2OBJ[i + 1]] for i in range(6)])


@lru_cache(maxsize=None)
def load_model_points(split: str = "test") -> dict:
    """instance -> (1024, 3) model points (real_{train,test}_spd.pkl)."""
    path = meta.TRAIN_MODEL_PATH if split == "train" else meta.TEST_MODEL_PATH
    d = _load_pickle(path)
    return {k: np.asarray(v, dtype=np.float32) for k, v in d.items()}


@lru_cache(maxsize=None)
def load_abs_scales(path: str = meta.ABS_SCALE_PATH) -> dict:
    """instance -> (3,) metric size."""
    d = _load_pickle(path)
    return {k: np.asarray(v, dtype=np.float32) for k, v in d.items()}


@lru_cache(maxsize=None)
def load_mug_meta(path: str = meta.MUG_META_PATH) -> dict:
    """mug instance -> (t0 (3,), s0 scalar) NOCS remap (`nocs.py:104-107`,
    used `data_loader.py:606-609`: nocs = s0 * (nocs + t0))."""
    d = _load_pickle(path)
    return {k: (np.asarray(v[0], dtype=np.float32), float(v[1])) for k, v in d.items()}


@lru_cache(maxsize=None)
def load_mug_handle(path: str = meta.MUG_HANDLE_PATH) -> dict:
    """scene_im or instance key -> handle visibility flag."""
    return _load_pickle(path)


@lru_cache(maxsize=None)
def load_fps_points(path: str = meta.FPS_POINTS_PATH) -> dict:
    """Raw fps-keypoint pickle. Two formats are accepted:
      - reference: inst -> {f"fps{N}_and_center": (N+1, 3)} (consumed
        `data_loader.py:337-352`, produced by the authors' sampling tool)
      - flat: inst -> (N, 3) (produced by `tools/fps_sample.py`)
    Use `get_fps_points` for a normalized per-instance view."""
    if not osp.exists(path):
        raise FileNotFoundError(path)
    return _load_pickle(path)


def get_fps_points(inst_name: str, num_kps: int, with_center: bool = False,
                   path: str = meta.FPS_POINTS_PATH) -> np.ndarray:
    """(num_kps[+1], 3) fps keypoints for one instance — the reference's
    `CATRE_DatasetFromList._get_fps_points` (`data_loader.py:337-352`: selects
    the `fps{NUM_KPS}_and_center` entry and drops the trailing center row
    unless with_center)."""
    entry = load_fps_points(path)[inst_name]
    if isinstance(entry, dict):  # reference nested format
        arr = np.asarray(entry[f"fps{num_kps}_and_center"], dtype=np.float32)
        return arr if with_center else arr[:-1]
    arr = np.asarray(entry, dtype=np.float32)  # flat (N, 3)
    n = num_kps + 1 if with_center else num_kps
    if arr.shape[0] < n:
        raise ValueError(
            f"fps pickle entry {inst_name!r} has {arr.shape[0]} points; "
            f"{n} requested (INPUT.NUM_KPS) — regenerate with "
            f"tools/fps_sample.py --num-points {num_kps}")
    return arr[:n]
