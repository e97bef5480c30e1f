"""Symmetry rotation bank and batched closest-rotation selection.

Counterpart of `catre_tpu/geom/symmetry.py`: `axis_symmetry_rotation_bank`
(:23, numpy, copied), `closest_rot_batch` (:57) and `y_rotation_bank_20`
(:83, numpy, copied): one (K, 3, 3) bank shared by every sample and a
per-sample `sym_flag`; the closest gt rotation is a batched trace-argmax.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def axis_symmetry_rotation_bank(axis=(0, 1, 0), max_sym_disc_step: float = 0.01,
                                include_identity: bool = True) -> np.ndarray:
    """Rotations about `axis` at angles i * 2pi / ceil(pi / step), i = 1..count-1,
    identity first when `include_identity`: (K, 3, 3) float32."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    count = int(np.ceil(np.pi / max_sym_disc_step))
    angles = np.arange(1, count) * (2.0 * np.pi / count)
    x, y, z = axis
    c, s = np.cos(angles), np.sin(angles)
    C = 1 - c
    rots = np.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        x * y * C + z * s, y * y * C + c, y * z * C - x * s,
        x * z * C - y * s, y * z * C + x * s, z * z * C + c,
    ], axis=-1).reshape(-1, 3, 3)
    if include_identity:
        rots = np.concatenate([np.eye(3)[None], rots], axis=0)
    return rots.astype(np.float32)


def closest_rot_batch(pred_rots: torch.Tensor, gt_rots: torch.Tensor,
                      sym_flags: torch.Tensor, sym_bank: torch.Tensor) -> torch.Tensor:
    """Per sample, the candidate gt @ bank[k] with the largest trace(pred^T
    cand) (the first on ties, as `jnp.argmax`); non-symmetric samples keep
    gt (bank[0] is the identity). (B, 3, 3) each, sym_flags (B,) bool."""
    cand = torch.einsum("bij,kjl->bkil", gt_rots, sym_bank)      # (B, K, 3, 3)
    tr = torch.einsum("bij,bkij->bk", pred_rots, cand)
    k_best = torch.where(sym_flags, torch.argmax(tr, dim=1), 0)
    return cand[torch.arange(cand.shape[0], device=cand.device), k_best]


def y_rotation_bank_20() -> np.ndarray:
    """The 20 y-axis rotations of the fixed-IoU eval for symmetric classes,
    as (20, 4, 4) float64 matrices."""
    n = 20
    thetas = 2.0 * math.pi * np.arange(n) / n
    c, s = np.cos(thetas), np.sin(thetas)
    out = np.zeros((n, 4, 4), dtype=np.float64)
    out[:, 0, 0] = c
    out[:, 0, 2] = s
    out[:, 1, 1] = 1
    out[:, 2, 0] = -s
    out[:, 2, 2] = c
    out[:, 3, 3] = 1
    return out
