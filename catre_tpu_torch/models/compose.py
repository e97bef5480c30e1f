"""Delta -> absolute pose/scale composition on torch tensors.

Counterpart of `catre_tpu/models/compose.py::pose_scale_from_delta_init`
(:16), every branch: image-space or 3D translation deltas, cosypose or
deepim depth, K-aware or not, add or mul scale, ego or allo rotation.
"""

from __future__ import annotations

import torch

from ..geom.rotations import allo_to_ego_mat


def pose_scale_from_delta_init(
    rot_deltas: torch.Tensor,      # (B, 3, 3)
    trans_deltas: torch.Tensor,    # (B, 3): vx, vy, vz in image space, or 3D
    scale_deltas: torch.Tensor,    # (B, 3)
    rot_inits: torch.Tensor,       # (B, 3, 3)
    trans_inits: torch.Tensor,     # (B, 3)
    scale_inits: torch.Tensor,     # (B, 3): init scale (iter_*) or mean scale (mean_*)
    Ks: torch.Tensor | None = None,  # (B, 3, 3)
    K_aware: bool = True,
    delta_T_space: str = "image",
    delta_T_weight: float = 1.0,
    delta_z_style: str = "cosypose",
    eps: float = 1e-4,
    is_allo: bool = False,
    scale_type: str = "iter_add",
):
    """Returns (rot_tgts (B, 3, 3), trans_tgts (B, 3), scale_tgts (B, 3))."""
    trans_deltas = trans_deltas * delta_T_weight

    if delta_T_space == "image":
        zsrc = trans_inits[:, 2:3]
        vz = trans_deltas[:, 2:3]
        if delta_z_style == "cosypose":
            ztgt = vz * zsrc
        else:  # deepim: vz = log(zsrc / ztgt)
            ztgt = zsrc / torch.exp(vz)
        vxvy = trans_deltas[:, :2]
        if K_aware:
            if Ks is None:
                raise ValueError("K_aware composition needs Ks")
            fxfy = torch.stack([Ks[:, 0, 0], Ks[:, 1, 1]], dim=1)
        else:
            fxfy = torch.ones_like(vxvy)
        xy_tgt = ztgt * (vxvy / fxfy + trans_inits[:, :2] / zsrc)
        trans_tgts = torch.cat([xy_tgt, ztgt], dim=-1)
    elif delta_T_space == "3D":
        trans_tgts = trans_inits + trans_deltas
    else:
        raise ValueError(f"Unknown delta_T_space: {delta_T_space}")

    if "add" in scale_type:
        scale_tgts = scale_inits + scale_deltas
    else:  # *_mul: scale_deltas = log(s / s_init)
        scale_tgts = scale_inits * torch.exp(scale_deltas)

    ego_rot_deltas = allo_to_ego_mat(trans_tgts, rot_deltas, eps=eps) if is_allo else rot_deltas
    return ego_rot_deltas @ rot_inits, trans_tgts, scale_tgts
