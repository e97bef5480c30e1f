"""Point-matching loss, symmetry-aware.

Counterpart of `catre_tpu/losses/pm_loss.py::pm_loss` (:22), every branch:
the prior keypoints are rotated (and scaled) by the prediction and by the
gt, whose symmetric samples take the bank rotation closest to the detached
prediction (:79); the per-sample pair loss is a masked batch mean, times 3
for the mean over the coordinate axis (:91).
"""

from __future__ import annotations

import torch

from ..geom.symmetry import closest_rot_batch
from ..geom.transforms import transform_normed_pts
from .common import elementwise, l2_norm_per_sample, masked_mean


def pm_loss(pred_rots, gt_rots, points, pred_transes=None, gt_transes=None, pred_scales=None,
            gt_scales=None, sym_flags=None, sym_bank=None, valid_mask=None,
            loss_type: str = "l1", beta: float = 1.0, loss_weight: float = 1.0,
            symmetric: bool = True, r_only: bool = True, with_scale: bool = True,
            disentangle_t: bool = False, disentangle_z: bool = False,
            t_loss_use_points: bool = True, norm_by_extent: bool = False,
            extents=None, count=None) -> dict:
    """{'loss_PM_R': ...} in the shipped config; see the JAX docstring for
    each branch. `count`: valid_mask's sum over the whole batch where these
    rows are one process's share (`losses.common.masked_mean`)."""
    if loss_type.lower() == "l2":
        def pair(a, b):
            return l2_norm_per_sample(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1))
    else:
        fn = elementwise(loss_type, beta)

        def pair(a, b):
            d = fn(a, b)
            return d if d.dim() == 1 else d.mean(dim=tuple(range(1, d.dim())))

    if norm_by_extent:
        if extents is None:
            raise ValueError("norm_by_extent requires extents")
        weights = 1.0 / torch.clamp(extents.amax(dim=1, keepdim=True), min=1e-6)
        points = points * weights[:, :, None]

    if symmetric:
        if sym_flags is None or sym_bank is None:
            raise ValueError("the symmetric PM loss needs sym_flags and sym_bank")
        gt_rots = closest_rot_batch(pred_rots.detach(), gt_rots, sym_flags, sym_bank)

    points_est = transform_normed_pts(points, pred_rots, t=None,
                                      scale=pred_scales if with_scale else None)
    points_tgt = transform_normed_pts(points, gt_rots, t=None,
                                      scale=gt_scales if with_scale else None)

    def pm_mean(a, b):
        return masked_mean(pair(a, b), valid_mask, count)

    if r_only:
        return {"loss_PM_R": 3.0 * pm_mean(points_est, points_tgt) * loss_weight}

    if pred_transes is None or gt_transes is None:
        raise ValueError("the PM loss with translation needs pred_transes and gt_transes")
    if disentangle_z:
        if t_loss_use_points:
            tgt_rt = points_tgt + gt_transes[:, None, :]
            est_r = points_est + gt_transes[:, None, :]
            pt_xy = torch.cat([pred_transes[:, :2], gt_transes[:, 2:3]], dim=1)
            pt_z = torch.cat([gt_transes[:, :2], pred_transes[:, 2:3]], dim=1)
            return {
                "loss_PM_R": 3.0 * pm_mean(est_r, tgt_rt) * loss_weight,
                "loss_PM_xy": 3.0 * pm_mean(points_tgt + pt_xy[:, None, :], tgt_rt) * loss_weight,
                "loss_PM_z": 3.0 * pm_mean(points_tgt + pt_z[:, None, :], tgt_rt) * loss_weight,
            }
        return {
            "loss_PM_R": 3.0 * pm_mean(points_est, points_tgt) * loss_weight,
            "loss_PM_xy_noP": masked_mean(pair(pred_transes[:, :2], gt_transes[:, :2]),
                                          valid_mask, count),
            "loss_PM_z_noP": masked_mean(pair(pred_transes[:, 2:3], gt_transes[:, 2:3]),
                                         valid_mask, count),
        }
    if disentangle_t:
        if t_loss_use_points:
            tgt_rt = points_tgt + gt_transes[:, None, :]
            return {
                "loss_PM_R": 3.0 * pm_mean(points_est + gt_transes[:, None, :], tgt_rt)
                * loss_weight,
                "loss_PM_T": 3.0 * pm_mean(points_tgt + pred_transes[:, None, :], tgt_rt)
                * loss_weight,
            }
        return {
            "loss_PM_R": 3.0 * pm_mean(points_est, points_tgt) * loss_weight,
            "loss_PM_T_noP": masked_mean(pair(pred_transes, gt_transes), valid_mask, count),
        }
    tgt_rt = points_tgt + gt_transes[:, None, :]
    est_rt = points_est + pred_transes[:, None, :]
    return {"loss_PM_RT": 3.0 * pm_mean(est_rt, tgt_rt) * loss_weight}
