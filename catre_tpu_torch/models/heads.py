"""Disentangled delta heads on factored encoder features.

Counterpart of `catre_tpu/models/heads.py`: `RotHead` (:68),
`ConvOutPerRotHead` (:129) and `FCTransSizeHead` (:173). The rotation head
takes the encoder's per-point 64-d features and per-cloud 1024-d globals;
its layer-0 weight is split along the input channels, global rows first
(`heads.py:102`): y = pf @ W_pt^T + g @ W_g^T + b. These modules are the
plain path; `ops.rot_head.fused_conv_per_rot_head` runs both rotation heads
in one kernel on the same parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Dense, GroupNorm, dense, gelu_exact


class RotHead(nn.Module):
    """One per-axis rotation head: layer0 (split) -> GN -> GELU, then
    (layer_i -> GN -> GELU) for i < num_layers, neck, and conv_p (a learned
    weighted sum over the P + K points). Weights N(0, 0.001), zero biases."""

    def __init__(self, generator: torch.Generator, in_global: int = 1024, in_point: int = 64,
                 feat_dim: int = 256, num_layers: int = 2, rot_dim: int = 3,
                 num_gn_groups: int = 32, num_points: int = 2048,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        # one (feat, in_global + in_point) draw, split: the same law as the
        # JAX package's single layer0_kernel
        w0 = torch.empty(feat_dim, in_global + in_point).normal_(0.0, 0.001, generator=generator)
        self.layer0_global_weight = nn.Parameter(w0[:, :in_global].clone())
        self.layer0_point_weight = nn.Parameter(w0[:, in_global:].clone())
        self.layer0_bias = nn.Parameter(torch.zeros(feat_dim))
        self.gns = nn.ModuleList([GroupNorm(num_gn_groups, feat_dim)])
        self.layers = nn.ModuleList()
        for _ in range(1, num_layers):
            self.layers.append(Dense(feat_dim, feat_dim, generator, init="normal", dtype=dtype))
            self.gns.append(GroupNorm(num_gn_groups, feat_dim))
        self.neck = Dense(feat_dim, rot_dim, generator, init="normal", dtype=dtype)
        self.point_weight = nn.Parameter(
            torch.empty(num_points).normal_(0.0, 0.001, generator=generator))
        self.point_bias = nn.Parameter(torch.zeros(1))

    def forward(self, point_feats, g_pcl, g_kps, n_pcl: int):
        cdt = point_feats.dtype if self.dtype is None else self.dtype
        w_g = self.layer0_global_weight
        g_terms = dense(torch.stack([g_pcl, g_kps], dim=1), w_g, None, cdt)   # (B, 2, F)
        x = dense(point_feats, self.layer0_point_weight, None, cdt)            # (B, P+K, F)
        is_pcl = (torch.arange(x.shape[1], device=x.device) < n_pcl)[None, :, None]
        x = x + torch.where(is_pcl, g_terms[:, 0:1], g_terms[:, 1:2])
        x = gelu_exact(self.gns[0](x + self.layer0_bias.to(cdt)))
        for layer, gn in zip(self.layers, self.gns[1:]):
            x = gelu_exact(gn(layer(x)))
        x = self.neck(x)                                                       # (B, P+K, rot)
        return torch.einsum("bpd,p->bd", x, self.point_weight.to(x.dtype)) + \
            self.point_bias.to(x.dtype)


class ConvOutPerRotHead(nn.Module):
    """Two independent RotHeads (x axis, y axis), outputs concatenated:
    (B, rot_dim + rot_dim_y). Odd total widths split ceil/floor."""

    def __init__(self, generator: torch.Generator, in_global: int = 1024, in_point: int = 64,
                 feat_dim: int = 256, num_layers: int = 2, rot_dim: int = 3,
                 rot_dim_y: int | None = None, num_gn_groups: int = 32,
                 num_points: int = 2048, dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(in_global=in_global, in_point=in_point, feat_dim=feat_dim,
                  num_layers=num_layers, num_gn_groups=num_gn_groups,
                  num_points=num_points, dtype=dtype)
        self.rot_head_x = RotHead(generator, rot_dim=rot_dim, **kw)
        self.rot_head_y = RotHead(
            generator, rot_dim=rot_dim if rot_dim_y is None else rot_dim_y, **kw)

    def forward(self, point_feats, g_pcl, g_kps, n_pcl: int):
        return torch.cat([self.rot_head_x(point_feats, g_pcl, g_kps, n_pcl),
                          self.rot_head_y(point_feats, g_pcl, g_kps, n_pcl)], dim=1)


class FCTransSizeHead(nn.Module):
    """num_layers x (Dense -> GN -> GELU), then fc_t and fc_s:
    (B, in_dim) -> ((B, 3), (B, 3)). Weights N(0, 0.001) (fc_t/fc_s 0.01)."""

    def __init__(self, generator: torch.Generator, in_dim: int, feat_dim: int = 256,
                 num_layers: int = 2, num_gn_groups: int = 32, num_classes: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.linears = nn.ModuleList()
        self.gns = nn.ModuleList()
        for i in range(num_layers):
            self.linears.append(Dense(in_dim if i == 0 else feat_dim, feat_dim, generator,
                                      init="normal", dtype=dtype))
            self.gns.append(GroupNorm(num_gn_groups, feat_dim))
        self.fc_t = Dense(feat_dim, 3 * num_classes, generator, init="normal", std=0.01,
                          dtype=dtype)
        self.fc_s = Dense(feat_dim, 3 * num_classes, generator, init="normal", std=0.01,
                          dtype=dtype)

    def forward(self, x):
        for linear, gn in zip(self.linears, self.gns):
            x = gelu_exact(gn(linear(x)))
        return self.fc_t(x), self.fc_s(x)
