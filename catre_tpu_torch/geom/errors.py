"""Batched pose error metrics.

Counterpart of `catre_tpu/geom/errors.py`: `rotation_error_deg` (:13) and
`translation_error` (:29), the train step's logged errors.
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
