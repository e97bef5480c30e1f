"""Batched pose error metrics.

Counterpart of `catre_tpu/geom/errors.py`: `rotation_error_deg` (:13),
`translation_error` (:29), the train step's logged errors,
`rotation_error_deg_sym_y` (:34, the NOCS protocol's error) and `mean_re_te`
(:54).
"""

from __future__ import annotations

import torch


def rotation_error_deg(r_est: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees, arccos(clip((tr(R_est R_gt^T) - 1) / 2)):
    (..., 3, 3) -> (...,)."""
    tr = torch.einsum("...ij,...ij->...", r_est, r_gt)
    return torch.rad2deg(torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)))


def translation_error(t_est: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """L2 distance, (..., 3) -> (...,)."""
    return torch.linalg.norm(t_est - t_gt, dim=-1)


def rotation_error_deg_sym_y(r_est: torch.Tensor, r_gt: torch.Tensor,
                             sym_flags: torch.Tensor) -> torch.Tensor:
    """NOCS-protocol rotation error (B,): the angle between the transformed y
    axes for y-symmetric samples, the geodesic angle otherwise."""
    y_est, y_gt = r_est[..., :, 1], r_gt[..., :, 1]
    cos_sym = torch.sum(y_est * y_gt, dim=-1) / (
        torch.linalg.norm(y_est, dim=-1) * torch.linalg.norm(y_gt, dim=-1))
    err_sym = torch.rad2deg(torch.arccos(torch.clamp(cos_sym, -1.0, 1.0)))
    return torch.where(sym_flags, err_sym, rotation_error_deg(r_est, r_gt))


def mean_re_te(pred_trans: torch.Tensor, pred_rot: torch.Tensor, gt_trans: torch.Tensor,
               gt_rot: torch.Tensor):
    """Batch-mean rotation error (degrees) and translation error."""
    return (torch.mean(rotation_error_deg(pred_rot, gt_rot)),
            torch.mean(translation_error(pred_trans, gt_trans)))
