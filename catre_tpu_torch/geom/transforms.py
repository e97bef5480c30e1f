"""Batched rigid and similarity point transforms on torch tensors.

Counterpart of `catre_tpu/geom/transforms.py`: `transform_normed_pts`
(:13), `transform_pts` (:34) and `pose_compose_3x4` (:70). Points are
points-last, (B, P, 3).
"""

from __future__ import annotations

import torch


def transform_normed_pts(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor | None = None,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """`R @ (pts * scale) (+ t)`: pts (B, P, 3), R (B, 3, 3), t (B, 3) or
    (B, 3, 1), scale (B, 3) per-axis."""
    if scale is not None:
        pts = pts * scale[:, None, :]
    out = pts @ R.transpose(1, 2)
    if t is not None:
        out = out + t.reshape(t.shape[0], 1, 3)
    return out


def transform_pts(pts: torch.Tensor, R: torch.Tensor,
                  t: torch.Tensor | None = None) -> torch.Tensor:
    """`R @ pts (+ t)`: pts (B, P, 3), R (B, 3, 3), t (B, 3)."""
    return transform_normed_pts(pts, R, t)


def pose_compose_3x4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) + (B, 3) -> (B, 3, 4)."""
    return torch.cat([R, t[..., None]], dim=-1)
