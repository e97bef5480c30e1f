"""Shared PointNet encoder (no BatchNorm), points-last.

Counterpart of `catre_tpu/models/pointnet.py` (`STN` :19, `PointNetFeat`
:41) and of `catre_tpu/ops/pallas_encoder_epilogue.py::encode_body` (:107):
the forward pass is written once and takes the two `-> 1024 -> max` tails
as arguments, so the plain path and the kernel path
(`ops.encoder_epilogue.ENCODER_TAIL_KERNELS`) share every other line.

A tail pair is `(relu_max, relu_dense_max)`:
  relu_max(h, w, b, cdt)               -> (N, Cout) f32   (STN conv3 tails)
  relu_dense_max(h, w3, b3, w4, b4, cdt) -> (N, C4) f32   (main conv3->conv4)
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.encoder_epilogue import ENCODER_TAIL_TWINS
from .layers import Dense


class STN(nn.Module):
    """Spatial transformer predicting a (k, k) transform added to identity:
    k=3 is STN3d, k=64 is STNkd."""

    def __init__(self, k: int, generator: torch.Generator, dtype: torch.dtype | None = None):
        super().__init__()
        self.k = k
        self.dtype = dtype
        widths = [("conv1", k, 64), ("conv2", 64, 128), ("conv3", 128, 1024),
                  ("fc1", 1024, 512), ("fc2", 512, 256), ("fc3", 256, k * k)]
        for name, cin, cout in widths:
            setattr(self, name, Dense(cin, cout, generator, dtype=dtype))

    def forward(self, x: torch.Tensor, tails=ENCODER_TAIL_TWINS) -> torch.Tensor:
        cdt = x.dtype if self.dtype is None else self.dtype
        g = self.conv2(self.conv1(x, act=True), act=True)         # (N, P, 128)
        pooled = tails[0](g, self.conv3.weight, self.conv3.bias, cdt).to(cdt)
        f = self.fc3(self.fc2(self.fc1(pooled, act=True), act=True))
        iden = torch.eye(self.k, dtype=f.dtype, device=f.device).reshape(1, -1)
        return (f + iden).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """PointNet feature encoder in factored form (`return_parts=True` in the
    JAX package): (N, P, 3) -> (pointfeat (N, P, 64), gfeat (N, out_dim) f32).
    The reference's (N, P, out_dim + 64) concat is never built."""

    def __init__(self, generator: torch.Generator, out_dim: int = 1024,
                 feature_transform: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.feature_transform = feature_transform
        self.stn = STN(3, generator, dtype)
        self.conv1 = Dense(3, 64, generator, dtype=dtype)
        if feature_transform:
            self.fstn = STN(64, generator, dtype)
        self.conv2 = Dense(64, 128, generator, dtype=dtype)
        self.conv3 = Dense(128, 512, generator, dtype=dtype)
        self.conv4 = Dense(512, out_dim, generator, dtype=dtype)

    def forward(self, x: torch.Tensor, tails=ENCODER_TAIL_TWINS):
        cdt = x.dtype if self.dtype is None else self.dtype
        trans = self.stn(x, tails)
        x = torch.bmm(x.to(trans.dtype), trans)
        x = self.conv1(x, act=True)                               # (N, P, 64)
        if self.feature_transform:
            x = torch.bmm(x, self.fstn(x, tails))
        h = self.conv2(x, act=True)                               # (N, P, 128)
        gfeat = tails[1](h, self.conv3.weight, self.conv3.bias,
                         self.conv4.weight, self.conv4.bias, cdt)
        return x, gfeat
