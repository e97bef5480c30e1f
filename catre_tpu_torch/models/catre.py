"""CATRE: shared PointNet over the observed cloud and the transformed prior
keypoints, disentangled delta heads, pose/scale composition.

Counterpart of `catre_tpu/models/catre.py`: `CATREConfig` (:31),
`CATREDisRShared` (:77), `prepare_inputs` (:163), `refine_forward` (:341)
and `init_params` (:388). The JAX package writes the encoder->heads trunk
three times (the flax module :93, `delta_forward_fused` :186 and
`delta_forward_fused_train` :274); here it is written once, in
`CATREDisRShared.forward`, and the configuration picks its encoder tails
and rotation head:
  - `fused_heads` (rot6d only): rotation head kernel K3
    (`ops.rot_head.fused_conv_per_rot_head`), and with
    `fused_encoder_epilogue` the encoder tail kernels K1/K2
    (`ops.encoder_epilogue.ENCODER_TAIL_KERNELS`);
  - otherwise the plain modules, as the flax module runs.
On a CPU tensor every kernel wrapper runs its plain twin.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from ..geom.rotations import get_rot_dim, rot_rep_to_mat
from ..geom.transforms import transform_normed_pts
from ..ops.encoder_epilogue import ENCODER_TAIL_KERNELS, ENCODER_TAIL_TWINS
from ..ops.rot_head import fused_conv_per_rot_head
from .compose import pose_scale_from_delta_init
from .heads import ConvOutPerRotHead, FCTransSizeHead
from .pointnet import PointNetFeat


@dataclass(frozen=True)
class CATREConfig:
    """Static model hyper-parameters (shipped NOCS-REAL values)."""

    num_pcl: int = 1024
    num_kps: int = 1024
    pclnet_out_dim: int = 1024
    feature_transform: bool = True
    rot_feat_dim: int = 256
    rot_num_layers: int = 2
    rot_num_gn_groups: int = 32
    ts_feat_dim: int = 256
    ts_num_layers: int = 2
    ts_num_gn_groups: int = 32
    ts_with_kps_feature: bool = False
    ts_with_init_scale: bool = True
    ts_with_init_trans: bool = False
    rot_type: str = "ego_rot6d"          # {ego|allo}_{rot6d|quat|log_quat|lie_vec}
    scale_type: str = "iter_add"         # {iter|mean}_{add|mul}
    delta_t_space: str = "image"         # image | 3D
    delta_t_weight: float = 1.0
    delta_z_style: str = "cosypose"      # cosypose | deepim
    t_transform_k_aware: bool = True
    zero_center_input: bool = True
    refine_scale: bool = True
    dtype: torch.dtype | None = None     # compute dtype (None = float32)
    fused_heads: bool = False            # rotation head kernel K3 (rot6d only)
    fused_encoder_epilogue: bool = True  # encoder tail kernels K1/K2 (with fused_heads)

    @property
    def is_allo(self) -> bool:
        return "allo" in self.rot_type

    @property
    def rot_out_dim(self) -> int:
        return get_rot_dim(self.rot_type)

    @property
    def is_rot6d(self) -> bool:
        return self.rot_type.endswith("rot6d")

    @property
    def uses_rot_head_kernel(self) -> bool:
        return self.fused_heads and self.is_rot6d

    @property
    def uses_tail_kernels(self) -> bool:
        return self.uses_rot_head_kernel and self.fused_encoder_epilogue


class CATREDisRShared(nn.Module):
    """Delta-prediction network: encoder + heads.

    forward(x (B, P, 3), tfd_kps (B, K, 3), init_scale (B, 3), init_trans
    (B, 3)) -> rot_deltas (B, rot_out_dim), trans_deltas (B, 3),
    scale_deltas (B, 3), all f32. Parameters are made on the CPU from
    `generator` and moved to `device`.
    """

    def __init__(self, cfg: CATREConfig, generator: torch.Generator,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = cfg
        d = cfg.rot_out_dim
        self.pcl_net = PointNetFeat(generator, cfg.pclnet_out_dim, cfg.feature_transform,
                                    cfg.dtype)
        ts_in = (cfg.pclnet_out_dim + 64) * (2 if cfg.ts_with_kps_feature else 1) \
            + 3 * cfg.ts_with_init_scale + 3 * cfg.ts_with_init_trans
        self.ts_head = FCTransSizeHead(generator, ts_in, cfg.ts_feat_dim, cfg.ts_num_layers,
                                       cfg.ts_num_gn_groups, dtype=cfg.dtype)
        self.rot_head = ConvOutPerRotHead(
            generator, in_global=cfg.pclnet_out_dim, feat_dim=cfg.rot_feat_dim,
            num_layers=cfg.rot_num_layers, rot_dim=(d + 1) // 2, rot_dim_y=d // 2,
            num_gn_groups=cfg.rot_num_gn_groups, num_points=cfg.num_pcl + cfg.num_kps,
            dtype=cfg.dtype)
        self.to(device)

    def forward(self, x, tfd_kps, init_scale, init_trans=None):
        cfg = self.cfg
        B = x.shape[0]
        tails = ENCODER_TAIL_KERNELS if cfg.uses_tail_kernels else ENCODER_TAIL_TWINS
        # one encoder call over both clouds (2B) when the point counts match
        if x.shape[1] == tfd_kps.shape[1]:
            pf, gf = self.pcl_net(torch.cat([x, tfd_kps], dim=0), tails)
            pcl_pf, kps_pf, g_pcl, g_kps = pf[:B], pf[B:], gf[:B], gf[B:]
        else:
            pcl_pf, g_pcl = self.pcl_net(x, tails)
            kps_pf, g_kps = self.pcl_net(tfd_kps, tails)

        # flat feature = max over points of [global ⊕ point] = [g, max(point)]
        ts_parts = [g_pcl, pcl_pf.amax(dim=1).float()]
        if cfg.ts_with_kps_feature:
            ts_parts += [g_kps, kps_pf.amax(dim=1).float()]
        if cfg.ts_with_init_scale:
            ts_parts.append(init_scale.float())
        if cfg.ts_with_init_trans:
            if init_trans is None:
                raise ValueError("ts_with_init_trans needs init_trans")
            ts_parts.append(init_trans.float())
        trans_deltas, scale_deltas = self.ts_head(torch.cat(ts_parts, dim=1))

        point_feats = torch.cat([pcl_pf, kps_pf], dim=1)              # (B, P+K, 64)
        n_pcl = x.shape[1]
        if cfg.uses_rot_head_kernel:
            cdt = cfg.dtype or torch.float32
            rot_deltas = fused_conv_per_rot_head(point_feats, g_pcl, g_kps, self.rot_head,
                                                 n_pcl, cdt)
        else:
            rot_deltas = self.rot_head(point_feats, g_pcl, g_kps, n_pcl)
        return rot_deltas.float(), trans_deltas.float(), scale_deltas.float()


def init_model(cfg: CATREConfig, seed: int = 0,
               device: torch.device | str = "cpu") -> CATREDisRShared:
    """Seeded model in eval mode (`init_params` of the JAX package)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return CATREDisRShared(cfg, gen, device).eval()


def prepare_inputs(cfg: CATREConfig, pcl, obj_kps, pose_est, scale_est):
    """Network inputs of one refine iteration: tfd_kps = R_est (kps * s_est)
    (+ t_est unless zero-centred), x = pcl - t_est (zero-centred) or pcl.
    pcl (B, P, 3), obj_kps (B, K, 3), pose_est (B, 3, 4), scale_est (B, 3)."""
    r_est, t_est = pose_est[:, :3, :3], pose_est[:, :3, 3]
    tfd_kps = transform_normed_pts(
        obj_kps, r_est, t=None if cfg.zero_center_input else t_est, scale=scale_est)
    x = pcl - t_est[:, None, :] if cfg.zero_center_input else pcl
    return x, tfd_kps


def refine_forward(model: CATREDisRShared, pcl, obj_kps, pose_est, scale_est, K,
                   mean_scales=None):
    """One refine iteration: inputs -> deltas -> composed (pose (B, 3, 4),
    scale (B, 3))."""
    cfg = model.cfg
    x, tfd_kps = prepare_inputs(cfg, pcl, obj_kps, pose_est, scale_est)
    if cfg.dtype is not None:
        x, tfd_kps = x.to(cfg.dtype), tfd_kps.to(cfg.dtype)
    rot_deltas, trans_deltas, scale_deltas = model(x, tfd_kps, scale_est, pose_est[:, :3, 3])
    pred_rot, pred_trans, pred_scale = pose_scale_from_delta_init(
        rot_deltas=rot_rep_to_mat(rot_deltas, cfg.rot_type),
        trans_deltas=trans_deltas,
        scale_deltas=scale_deltas,
        rot_inits=pose_est[:, :3, :3],
        trans_inits=pose_est[:, :3, 3],
        scale_inits=scale_est if "iter" in cfg.scale_type else mean_scales,
        Ks=K,
        K_aware=cfg.t_transform_k_aware,
        delta_T_space=cfg.delta_t_space,
        delta_T_weight=cfg.delta_t_weight,
        delta_z_style=cfg.delta_z_style,
        is_allo=cfg.is_allo,
        scale_type=cfg.scale_type,
    )
    if not cfg.refine_scale:
        pred_scale = scale_est
    return torch.cat([pred_rot, pred_trans[:, :, None]], dim=-1), pred_scale
