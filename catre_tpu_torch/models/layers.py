"""Shared layers: torch-default and normal initialisers, a Dense that rounds
like flax `Dense(dtype=...)`, points-last GroupNorm with f32 statistics and
exact-erf GELU.

Counterpart of `catre_tpu/models/layers.py` (`TorchDense` :48, `HeadDense`
:65, `GroupNormPointsLast` :84, `gelu_exact` :122). Weights are stored as
PyTorch does, (out, in); activations are points-last, (B, P, C).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          cdt: torch.dtype, act: bool = False) -> torch.Tensor:
    """`round(round(x @ W^T) + b)` in compute dtype `cdt`, then optional
    ReLU: the flax `Dense(dtype=cdt)` rounding points (the product is
    rounded before the bias is added in `cdt`). `F.linear` with a bias would
    round once, so the bias is added separately."""
    out = F.linear(x.to(cdt), weight.to(cdt))
    if bias is not None:
        out = out + bias.to(cdt)
    return torch.relu(out) if act else out


class Dense(nn.Module):
    """Linear layer in (out, in) layout, applied by `dense`.

    init="torch": U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, PyTorch's
    default for Linear/Conv1d(k=1) (the encoder). init="normal": weight
    N(0, std), zero bias, mmcv `normal_init` (the heads).
    """

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator,
                 init: str = "torch", std: float = 0.001, use_bias: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(out_features, in_features)
        if init == "torch":
            bound = 1.0 / math.sqrt(in_features)
            w.uniform_(-bound, bound, generator=generator)
            b = torch.empty(out_features).uniform_(-bound, bound, generator=generator)
        elif init == "normal":
            w.normal_(0.0, std, generator=generator)
            b = torch.zeros(out_features)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b) if use_bias else None

    def forward(self, x: torch.Tensor, act: bool = False) -> torch.Tensor:
        cdt = x.dtype if self.dtype is None else self.dtype
        return dense(x, self.weight, self.bias, cdt, act)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of torch's `GroupNorm(G, C)` on (B, C, P), applied to
    points-last (B, P, C) or (B, C): statistics over (P, C/G) per (B, group),
    taken in f32; the output has the input's dtype."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    xf = x.float()
    shape = xf.shape
    g = xf.reshape(shape[0], -1, num_groups, C // num_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return (out * weight + bias).to(x.dtype)


class GroupNorm(nn.Module):
    """Points-last GroupNorm (`group_norm`) with affine weight and bias."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """GELU in its exact erf form (torch `nn.GELU()` default)."""
    return F.gelu(x, approximate="none")
