"""Elementwise loss primitives and the masked batch mean.

Counterpart of `catre_tpu/losses/common.py`: every batch reduction is a mean
over the valid samples, so padded rows never count. Where the batch is split
over processes, JAX's mean is over the global batch (GSPMD makes its sums
psums); here each process divides its own sum by the mask's count over the
group (`count`), and the processes' shares, like their gradients, sum to the
global mean.
"""

from __future__ import annotations

import torch


def masked_mean(per_sample: torch.Tensor, mask: torch.Tensor | None,
                count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of per-sample values over the entries where mask (B,) is set (all
    of them without a mask). `count`: the mask's sum over the whole batch of
    which these rows are one process's share; the result is then that share
    of the whole batch's mean."""
    if mask is None:
        return per_sample.mean() if count is None else per_sample.sum() / count.clamp(min=1.0)
    m = mask.to(per_sample.dtype)
    return (per_sample * m).sum() / torch.clamp(m.sum() if count is None else count, min=1.0)


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
