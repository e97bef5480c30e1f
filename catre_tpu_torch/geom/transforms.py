"""Batched rigid and similarity point transforms on torch tensors.

Counterpart of `catre_tpu/geom/transforms.py`: `transform_normed_pts`
(:13), `transform_pts` (:34), `backproject` (:42), `project_pts` (:60),
`pose_compose_3x4` (:70) and `pose_3x4_to_4x4_np` / `pose_3x4_to_4x4` (:75,
:87). Points are points-last, (B, P, 3).
"""

from __future__ import annotations

import numpy as np
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


def backproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole depth (..., H, W) in metres with intrinsics (..., 3, 3) ->
    organized cloud (..., H, W, 3), in the f32 op order of the JAX function:
    `(pix - c) * depth / f`. The focal lengths divide as tensors on the
    depth's device, so CUDA divides as the CPU does (a CPU scalar divisor
    becomes a multiplication by its reciprocal there)."""
    h, w = depth.shape[-2:]
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None] - K[..., 1, 2, None, None]
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :] - K[..., 0, 2, None, None]
    return torch.stack([xs * depth / K[..., 0, 0, None, None],
                        ys * depth / K[..., 1, 1, None, None],
                        depth], dim=-1)


def project_pts(pts: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """Project (P, 3) points with K [R | t] -> (P, 2) pixels."""
    uvw = (pts @ R.T + t.reshape(1, 3)) @ K.T
    return uvw[:, :2] / uvw[:, 2:3]


def pose_3x4_to_4x4_np(pose) -> np.ndarray:
    """Host numpy (..., 3, 4) -> (..., 4, 4) with an exact [0, 0, 0, 1]
    bottom row."""
    pose = np.asarray(pose)
    bottom = np.zeros(pose.shape[:-2] + (1, 4), dtype=pose.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([pose, bottom], axis=-2)


def pose_3x4_to_4x4(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) homogeneous."""
    bottom = pose.new_zeros(pose.shape[:-2] + (1, 4))
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)
