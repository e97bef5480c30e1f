"""Elementwise loss primitives and the masked batch mean.

Counterpart of `catre_tpu/losses/common.py`: every batch reduction is a mean
over the valid samples, so padded rows never count.
"""

from __future__ import annotations

import torch


def masked_mean(per_sample: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean of per-sample values over the entries where mask (B,) is set."""
    if mask is None:
        return per_sample.mean()
    m = mask.to(per_sample.dtype)
    return (per_sample * m).sum() / torch.clamp(m.sum(), min=1.0)


def l1(pred, target):
    return torch.abs(pred - target)


def mse(pred, target):
    return torch.square(pred - target)


def smooth_l1(pred, target, beta: float = 1.0):
    """fvcore smooth_l1_loss (PM_LOSS_TYPE='Smooth_L1')."""
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def l2_norm_per_sample(pred, target):
    """Per-sample L2 norm of the flattened difference (not squared)."""
    return torch.linalg.norm((pred - target).reshape(pred.shape[0], -1), dim=1)


def elementwise(loss_type: str, beta: float = 1.0):
    lt = loss_type.lower()
    if lt == "l1":
        return l1
    if lt == "mse":
        return mse
    if lt == "smooth_l1":
        return lambda p, t: smooth_l1(p, t, beta)
    raise ValueError(f"unsupported elementwise loss type: {loss_type}")
