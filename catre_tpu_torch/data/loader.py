"""The loader's device half: a group of decoded frames -> the refine's clouds.

Counterpart of the device part of `catre_tpu/data/loader.py`: `LoaderConfig`
(:53, the sampler's fields), `auto_sample_window` (:154), `_mask_pack_dtype`
(:245), `_pack_masks` (:256), `_quantize_depth` (:268), `_wants_mask_bbox`
(:278), the mask-bbox rows of `_gather_image_record` (:318-321, :360-365),
`_make_one_image_fn` (:475), `_make_group_sampler` (:540),
`_make_cached_group_sampler` (:565), `_make_candidates_builder` (:589) and
`_make_presampled_group_sampler` (:617). The host half (decode, caches,
`CATRELoader`) is ROADMAP item 8.

A group is G images with M = `max_objs_per_image` instance slots each; one
call samples all of it as (G, M, ...) tensors. Host arrays move to the
builder's device, the card unless the caller asks for the CPU. The JAX jit
cache and its environment knobs are not carried: the fused and the
materialized windowed forms are two plain functions, `sample_group_from_depth`
and `sample_group_from_cloud`, held equal by the tests.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..geom.transforms import backproject
from ..ops.sampling import (batch_ball_crop, batch_ball_crop_candidates,
                            batch_ball_crop_from_depth, batch_select_from_candidates,
                            depth_metres, unpack_masks)
from .aug import aug_depth

logger = logging.getLogger(__name__)

_WINDOW_TRUNC_WARNED = False


@dataclass
class LoaderConfig:
    """The INPUT.* / DATALOADER.* fields of the sampler."""

    num_pcl: int = 1024
    depth_sample_ball_ratio: float = 0.6
    fps_sample: bool = False
    # INPUT.SAMPLE_WINDOW: the mask-bbox-centred candidate window (0 = the
    # full frame; -1 = auto, resolved by `auto_sample_window` before sampling)
    sample_window: int = 0
    aug_depth: bool = True
    drop_depth_prob: float = 0.5
    drop_depth_ratio: float = 0.2
    add_noise_depth_prob: float = 0.9
    add_noise_depth_level: float = 0.01
    max_objs_per_image: int = 8


def auto_sample_window(dataset_dicts: list, phase: str) -> int:
    """INPUT.SAMPLE_WINDOW = -1: the smallest multiple of 32 above every
    annotation bbox of the split plus 2 px (test: `bbox_est`, train: `bbox`),
    where the windowed crop equals the full-frame one; 0 (the full frame)
    when an annotation has no bbox."""
    m = 0.0
    for rec in dataset_dicts:
        for a in rec.get("annotations", []):
            bb = a.get("bbox_est" if phase == "test" else "bbox", a.get("bbox"))
            if bb is None:
                return 0
            x1, y1, x2, y2 = [float(v) for v in bb]
            m = max(m, x2 - x1, y2 - y1)
    if m <= 0:
        return 0
    return int(-(-(m + 2.0) // 32) * 32)


def mask_pack_dtype(m: int):
    """The narrowest unsigned word with m bits, or None for m > 32 (the
    masks then travel as the (M, H, W) bool stack)."""
    for dt, bits in ((np.uint8, 8), (np.uint16, 16), (np.uint32, 32)):
        if m <= bits:
            return dt
    return None


def pack_masks(masks: np.ndarray):
    """(M, H, W) bool -> (H, W) word with bit i set where instance i is; the
    stack itself when M > 32."""
    dt = mask_pack_dtype(masks.shape[0])
    if dt is None:
        return masks
    p = np.zeros(masks.shape[1:], dtype=dt)
    for i in range(masks.shape[0]):
        p |= masks[i].astype(dt) << dt(i)
    return p


def quantize_depth(depth: np.ndarray) -> np.ndarray:
    """f32 metres -> u16 millimetres where that round-trips (depth decoded
    from a 16-bit png always does); f32 unchanged otherwise."""
    if float(depth.max()) * 1000.0 < 65535.5 and float(depth.min()) >= 0.0:
        return np.round(depth * 1000.0).astype(np.uint16)
    return depth


def wants_mask_bbox(cfg: LoaderConfig, phase: str) -> bool:
    """True where the group sampler reads the host's mask bounds: the fused
    windowed form (a window, no FPS, no depth augmentation)."""
    return (cfg.sample_window > 0 and not cfg.fps_sample
            and not (cfg.aug_depth and phase == "train"))


def mask_bbox_rows(masks: np.ndarray, sample_window: int = 0) -> np.ndarray:
    """(M, H, W) bool -> (M, 4) int32 (r_min, r_max, c_min, c_max); an empty
    slot keeps the sentinel (H, -1, W, -1) that the device reduction gives.
    Warns once when a bbox is wider than `sample_window`."""
    global _WINDOW_TRUNC_WARNED
    m, h, w = masks.shape
    rows = np.empty((m, 4), dtype=np.int32)
    rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3] = h, -1, w, -1
    for i in range(m):
        r_any = masks[i].any(axis=1)
        if not r_any.any():
            continue
        rnz, cnz = np.flatnonzero(r_any), np.flatnonzero(masks[i].any(axis=0))
        rows[i] = (rnz[0], rnz[-1], cnz[0], cnz[-1])
        if sample_window > 0 and max(rnz[-1] - rnz[0], cnz[-1] - cnz[0]) >= sample_window \
                and not _WINDOW_TRUNC_WARNED:
            _WINDOW_TRUNC_WARNED = True
            logger.warning("SAMPLE_WINDOW=%d smaller than a %dx%d mask bbox: its border "
                           "pixels are not ball-crop candidates; use a larger window, -1 "
                           "(auto) or 0", sample_window, rnz[-1] - rnz[0] + 1,
                           cnz[-1] - cnz[0] + 1)
    return rows


def to_device(x, device) -> torch.Tensor:
    """A host array or tensor on `device`; uint16 / uint32 travel as their
    int16 / int32 views (see `ops.sampling.mask_words`)."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint16:
            x = x.view(np.int16)
        elif x.dtype == np.uint32:
            x = x.view(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _check_window(cfg: LoaderConfig) -> None:
    if cfg.sample_window < 0:
        raise ValueError("LoaderConfig.sample_window = -1: resolve it with auto_sample_window "
                         "before building a sampler")


# ---- one group, on the tensors' device

def sample_group_from_depth(cfg: LoaderConfig, depths, Ks, packed, poses, scales, mask_bboxes,
                            priorities=None, generator=None):
    """The fused windowed form: each instance slices its window of the raw
    frame with the host's mask bounds. depths (G, H, W), Ks (G, 3, 3), packed
    (G, H, W) words or (G, M, H, W) bool, poses (G, M, 3, 4), scales (G, M,
    3), mask_bboxes (G, M, 4), priorities (G, M, wsh * wsw) -> (pcls (G, M,
    P, 3), idx (G, M, P) flat pixel indices, n_inside (G, M))."""
    _check_window(cfg)
    return batch_ball_crop_from_depth(depths, Ks, packed, mask_bboxes, poses, scales,
                                      cfg.depth_sample_ball_ratio, cfg.num_pcl,
                                      cfg.sample_window, priorities, generator)


def sample_group_from_cloud(cfg: LoaderConfig, train_aug: bool, depths, Ks, packed, poses,
                            scales, priorities=None, aug_draws=None, generator=None):
    """The materialized form: metres, the train-phase depth augmentation,
    the full-frame cloud and the unpacked masks, then `batch_ball_crop`
    (full frame, or windows whose bounds are reduced here from the masks).
    `aug_draws`: the `aug_depth` override arguments, each with G in front."""
    _check_window(cfg)
    depth = depth_metres(depths)
    if train_aug:
        depth = aug_depth(depth, generator, drop_depth_prob=cfg.drop_depth_prob,
                          drop_depth_ratio=cfg.drop_depth_ratio,
                          add_noise_depth_prob=cfg.add_noise_depth_prob,
                          add_noise_depth_level=cfg.add_noise_depth_level, **(aug_draws or {}))
    masks = unpack_masks(packed, poses.shape[-3])
    return batch_ball_crop(backproject(depth, Ks), masks, poses, scales,
                           cfg.depth_sample_ball_ratio, cfg.num_pcl, fps_sample=cfg.fps_sample,
                           window_size=cfg.sample_window, priorities=priorities,
                           generator=generator)


def sample_group(cfg: LoaderConfig, train_aug: bool, depths, Ks, packed, poses, scales,
                 mask_bboxes, priorities=None, aug_draws=None, generator=None):
    """One group through the form the JAX image function takes: fused where
    a window smaller than the frame runs without augmentation or FPS, else
    the materialized form."""
    h, w = depths.shape[-2:]
    ws = cfg.sample_window
    if ws > 0 and not train_aug and not cfg.fps_sample and (ws < h or ws < w):
        return sample_group_from_depth(cfg, depths, Ks, packed, poses, scales, mask_bboxes,
                                       priorities, generator)
    return sample_group_from_cloud(cfg, train_aug, depths, Ks, packed, poses, scales,
                                   priorities, aug_draws, generator)


# ---- the builders

def make_group_sampler(cfg: LoaderConfig, train_aug: bool, device="cuda"):
    """sample(depths, Ks, packed, poses, scales, mask_bboxes, priorities=None,
    aug_draws=None, generator=None) -> (pcls, idx, n_inside), each (G, M,
    ...), on `device`; host arrays move there."""
    _check_window(cfg)

    def sample(depths, Ks, packed, poses, scales, mask_bboxes, priorities=None,
               aug_draws=None, generator=None):
        args = [to_device(a, device) for a in (depths, Ks, packed, poses, scales, mask_bboxes)]
        return sample_group(cfg, train_aug, *args, priorities=priorities,
                            aug_draws=aug_draws, generator=generator)

    return sample


def make_cached_group_sampler(cfg: LoaderConfig, train_aug: bool, device="cuda"):
    """The device-cache form: the per-record stacks stay on `device` and a
    call gathers the group's rows by record index. sample(depth_all,
    packed_all, K_all, pose_all, scale_all, bbox_all, idx, priorities=None,
    aug_draws=None, generator=None)."""
    _check_window(cfg)

    def sample(depth_all, packed_all, K_all, pose_all, scale_all, bbox_all, idx,
               priorities=None, aug_draws=None, generator=None):
        idx = to_device(idx, device)
        rows = [to_device(a, device)[idx]
                for a in (depth_all, K_all, packed_all, pose_all, scale_all, bbox_all)]
        return sample_group(cfg, train_aug, *rows, priorities=priorities,
                            aug_draws=aug_draws, generator=generator)

    return sample


def make_candidates_builder(cfg: LoaderConfig, device="cuda"):
    """The deterministic half for a chunk of device-cache rows, computed once
    per record on the frozen eval path. build(depth_all, packed_all, K_all,
    pose_all, scale_all, bbox_all, idx) -> (pts, inside, n_inside, origin),
    each (G, M, ...)."""
    _check_window(cfg)

    def build(depth_all, packed_all, K_all, pose_all, scale_all, bbox_all, idx):
        idx = to_device(idx, device)
        depth, K, packed, poses, scales, bbox = [
            to_device(a, device)[idx]
            for a in (depth_all, K_all, packed_all, pose_all, scale_all, bbox_all)]
        return batch_ball_crop_candidates(depth, K, packed, bbox, poses, scales,
                                          cfg.depth_sample_ball_ratio, cfg.sample_window)

    return build


def make_presampled_group_sampler(cfg: LoaderConfig, img_w: int, wsw: int, device="cuda"):
    """The frozen eval sampler over precomputed candidates: the randomized
    half only. sample(pts_all, inside_all, nin_all, org_all, idx,
    priorities=None, generator=None); composed with the candidates builder it
    equals the cached sampler."""

    def sample(pts_all, inside_all, nin_all, org_all, idx, priorities=None, generator=None):
        idx = to_device(idx, device)
        pts, inside, n_in, org = [to_device(a, device)[idx]
                                  for a in (pts_all, inside_all, nin_all, org_all)]
        return batch_select_from_candidates(pts, inside, n_in, org, cfg.num_pcl, img_w, wsw,
                                            priorities, generator)

    return sample
