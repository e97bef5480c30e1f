"""The combined CATRE training loss.

Counterpart of `catre_tpu/losses/catre_loss.py`: `LossConfig` (:21),
`angular_distance_rot` (:44) and `catre_loss` (:52), every loss-type branch.
The symmetric / non-symmetric split is a pair of masked means; an empty
subset contributes 0. Over several processes each mean divides by its mask's
count over the group (`counts`, of the masks of `loss_masks`), so that the
processes' losses and gradients sum to the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import elementwise, l2_norm_per_sample, masked_mean
from .pm_loss import pm_loss


@dataclass(frozen=True)
class LossConfig:
    """Shipped NOCS-REAL loss configuration (`configs/...120e.py:113-135`)."""

    pm_loss_type: str = "L1"
    pm_smooth_l1_beta: float = 1.0
    pm_loss_sym: bool = True
    pm_r_only: bool = True
    pm_with_scale: bool = True
    pm_disentangle_t: bool = False
    pm_disentangle_z: bool = False
    pm_t_use_points: bool = True
    pm_lw: float = 1.0
    pm_norm_by_extent: bool = False
    rot_loss_type: str = "angular"       # angular | L2
    rot_yaxis_loss_type: str = "L1"      # L1 | smoothL1 | L2 | angular
    rot_lw: float = 1.0
    trans_loss_type: str = "L1"
    trans_loss_disentangle: bool = True
    trans_lw: float = 1.0
    scale_loss_type: str = "L1"
    scale_lw: float = 1.0


def angular_distance_rot(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """(1 - cos theta) / 2 per sample, from trace(m1 m2^T)."""
    cos = (torch.einsum("bij,bij->b", m1, m2) - 1.0) / 2.0
    return (1.0 - cos) / 2.0


def loss_masks(sym_flags: torch.Tensor, valid_mask=None) -> dict:
    """The masks of the loss's batch means, as floats: "valid" (every row
    without a valid_mask), and the non-symmetric ("nonsym") and symmetric
    ("sym") rows among them."""
    valid = (torch.ones(sym_flags.shape[0], dtype=torch.float32, device=sym_flags.device)
             if valid_mask is None else valid_mask.float())
    sym = sym_flags.float()
    return {"valid": valid, "nonsym": valid * (1.0 - sym), "sym": valid * sym}


def catre_loss(cfg: LossConfig, out_rot, out_trans, out_scale, gt_rot, gt_trans, gt_scale,
               obj_kps, sym_flags, sym_bank, valid_mask=None, counts: dict | None = None) -> dict:
    """Loss terms by name: rotations (B, 3, 3), translations and scales
    (B, 3), obj_kps (B, K, 3), sym_flags (B,) bool, sym_bank (S, 3, 3),
    valid_mask (B,) or None. `counts`: the sums of `loss_masks`' masks over
    the whole batch where these rows are one process's share of it (each
    term is then this process's share of the term)."""
    counts = counts or {}
    loss_dict = {}
    if cfg.pm_lw > 0:
        loss_dict.update(pm_loss(
            pred_rots=out_rot, gt_rots=gt_rot, points=obj_kps, pred_transes=out_trans,
            gt_transes=gt_trans, pred_scales=out_scale, gt_scales=gt_scale,
            sym_flags=sym_flags, sym_bank=sym_bank, valid_mask=valid_mask,
            loss_type=cfg.pm_loss_type, beta=cfg.pm_smooth_l1_beta, loss_weight=cfg.pm_lw,
            symmetric=cfg.pm_loss_sym, r_only=cfg.pm_r_only, with_scale=cfg.pm_with_scale,
            disentangle_t=cfg.pm_disentangle_t, disentangle_z=cfg.pm_disentangle_z,
            t_loss_use_points=cfg.pm_t_use_points, norm_by_extent=cfg.pm_norm_by_extent,
            extents=gt_scale, count=counts.get("valid")))

    if cfg.rot_lw > 0:
        masks = loss_masks(sym_flags, valid_mask)
        if cfg.rot_loss_type == "angular":
            per = angular_distance_rot(out_rot, gt_rot)
        elif cfg.rot_loss_type == "L2":
            per = torch.square(out_rot - gt_rot).mean(dim=(1, 2))
        else:
            raise ValueError(f"Unknown rot loss type: {cfg.rot_loss_type}")
        loss_dict["loss_rot"] = masked_mean(per, masks["nonsym"],
                                                counts.get("nonsym")) * cfg.rot_lw

        # symmetric objects: only the y column
        y_est, y_gt = out_rot[:, :, 1], gt_rot[:, :, 1]
        yt = cfg.rot_yaxis_loss_type
        if yt == "L1":
            per_y = torch.abs(y_est - y_gt).mean(dim=1)
        elif yt == "smoothL1":
            d = torch.abs(y_est - y_gt)
            per_y = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean(dim=1)
        elif yt == "L2":
            per_y = l2_norm_per_sample(y_est, y_gt)
        elif yt == "angular":
            cos = (y_est * y_gt).sum(dim=1) / (torch.linalg.norm(y_est, dim=1)
                                               * torch.linalg.norm(y_gt, dim=1))
            per_y = (1.0 - cos) / 2.0
        else:
            raise ValueError(f"Unknown rot yaxis loss type: {yt}")
        loss_dict["loss_yaxis_rot"] = masked_mean(per_y, masks["sym"],
                                                      counts.get("sym")) * cfg.rot_lw

    if cfg.trans_lw > 0:
        fn = elementwise(cfg.trans_loss_type if cfg.trans_loss_type != "L2" else "mse")
        if cfg.trans_loss_type == "L2":
            per_xy = l2_norm_per_sample(out_trans[:, :2], gt_trans[:, :2])
            per_z = torch.abs(out_trans[:, 2] - gt_trans[:, 2])
        else:
            per_xy = fn(out_trans[:, :2], gt_trans[:, :2]).mean(dim=1)
            per_z = fn(out_trans[:, 2], gt_trans[:, 2])
        if cfg.trans_loss_disentangle:
            loss_dict["loss_trans_xy"] = masked_mean(per_xy, valid_mask,
                                                       counts.get("valid")) * cfg.trans_lw
            loss_dict["loss_trans_z"] = masked_mean(per_z, valid_mask,
                                                       counts.get("valid")) * cfg.trans_lw
        else:
            per = fn(out_trans, gt_trans).mean(dim=1)
            loss_dict["loss_trans_LPnP"] = masked_mean(per, valid_mask,
                                                         counts.get("valid")) * cfg.trans_lw

    if cfg.scale_lw > 0:
        fn = elementwise(cfg.scale_loss_type if cfg.scale_loss_type != "L2" else "mse")
        if cfg.scale_loss_type == "L2":
            per = l2_norm_per_sample(out_scale, gt_scale)
        else:
            per = fn(out_scale, gt_scale).mean(dim=1)
        loss_dict["loss_scale"] = masked_mean(per, valid_mask, counts.get("valid")) \
            * cfg.scale_lw
    return loss_dict
