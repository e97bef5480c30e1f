"""Batched rotation representations on torch tensors.

Counterpart of `catre_tpu/geom/rotations.py`: `rot6d_to_mat`,
`quat_to_mat`, `axangle_to_mat`, `allo_to_ego_mat` (:159), `qexp`,
`lie_vec_to_mat`, `get_rot_dim` and `rot_rep_to_mat` (:262) for all eight
ROT_TYPEs. Same formulas and branch guards, so the two agree to float
rounding on the same inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rot6d_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt; columns [x|y|z]
    (`rotations.py:23`)."""
    x = F.normalize(d6[..., 0:3], dim=-1, eps=1e-12)
    z = F.normalize(torch.linalg.cross(x, d6[..., 3:6], dim=-1), dim=-1, eps=1e-12)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def quat_to_mat(quat: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit-normalised wxyz quaternion (..., 4) -> (..., 3, 3)
    (`rotations.py:47`)."""
    q = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + eps)
    qw, qx, qy, qz = q.unbind(-1)
    X, Y, Z = 2.0 * qx, 2.0 * qy, 2.0 * qz
    wX, wY, wZ = qw * X, qw * Y, qw * Z
    xX, xY, xZ = qx * X, qx * Y, qx * Z
    yY, yZ = qy * Y, qy * Z
    zZ = qz * Z
    m = torch.stack([
        1.0 - (yY + zZ), xY - wZ, xZ + wY,
        xY + wZ, 1.0 - (xX + zZ), yZ - wX,
        xZ - wY, yZ + wX, 1.0 - (xX + yY),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def axangle_to_mat(axis: torch.Tensor, angle: torch.Tensor,
                   is_normalized: bool = False) -> torch.Tensor:
    """Rodrigues: axis (..., 3), angle (...,) -> (..., 3, 3)
    (`rotations.py:132`)."""
    if not is_normalized:
        axis = F.normalize(axis, dim=-1, eps=1e-12)
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1 - c
    xs, ys, zs = x * s, y * s, z * s
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    m = torch.stack([
        x * xC + c, xyC - zs, zxC + ys,
        xyC + zs, y * yC + c, yzC - xs,
        zxC - ys, yzC + xs, z * zC + c,
    ], dim=-1)
    return m.reshape(axis.shape[:-1] + (3, 3))


def allo_to_ego_mat(translation: torch.Tensor, rot_allo: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """Allocentric -> egocentric rotation along the ray to the object
    centre. translation (B, 3), rot_allo (B, 3, 3) (`rotations.py:159`)."""
    obj_ray = translation / (torch.linalg.norm(translation, dim=1, keepdim=True) + eps)
    angle = torch.arccos(obj_ray[:, 2:3])
    cam_ray = obj_ray.new_tensor([0.0, 0.0, 1.0]).expand_as(obj_ray)
    axis = torch.linalg.cross(cam_ray, obj_ray, dim=1)
    axis = axis / (torch.linalg.norm(axis, dim=1, keepdim=True) + eps)
    half = angle / 2.0
    q = torch.cat([torch.cos(half), axis * torch.sin(half)], dim=1)
    return quat_to_mat(q) @ rot_allo


def qexp(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion exponential of a (B, 3) pure-imaginary or (B, 4) (s; v)
    log quaternion -> (B, 4) wxyz (`rotations.py:181`)."""
    if q.shape[-1] == 4:
        s, v = q[..., :1], q[..., 1:]
    else:
        s, v = torch.zeros_like(q[..., :1]), q
    theta2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = theta2 > eps * eps
    theta = torch.sqrt(torch.where(safe, theta2, torch.ones_like(theta2)))
    w = torch.where(safe, torch.cos(theta), torch.ones_like(theta))
    xyz = torch.where(safe, torch.sin(theta) / theta, torch.ones_like(theta)) * v
    return torch.exp(s) * torch.cat([w, xyz], dim=-1)


def lie_vec_to_mat(vec: torch.Tensor) -> torch.Tensor:
    """so(3) vector (..., 3) -> (..., 3, 3): Rodrigues above theta^2 = 1e-6,
    first-order Taylor below (`rotations.py:206`)."""
    theta2 = torch.sum(vec * vec, dim=-1)
    safe = theta2 > 1e-6
    theta = torch.sqrt(torch.where(safe, theta2, torch.ones_like(theta2)))
    r_exact = axangle_to_mat(vec / (theta[..., None] + 1e-6), theta, is_normalized=True)
    rx, ry, rz = vec.unbind(-1)
    one = torch.ones_like(rx)
    r_taylor = torch.stack(
        [one, -rz, ry, rz, one, -rx, -ry, rx, one], dim=-1
    ).reshape(vec.shape[:-1] + (3, 3))
    return torch.where(safe[..., None, None], r_exact, r_taylor)


ROT_DIMS = {
    "allo_quat": 4, "ego_quat": 4,
    "allo_log_quat": 3, "ego_log_quat": 3,
    "allo_lie_vec": 3, "ego_lie_vec": 3,
    "allo_rot6d": 6, "ego_rot6d": 6,
}


def get_rot_dim(rot_type: str) -> int:
    """Network rotation output width per ROT_TYPE (`rotations.py:253`)."""
    try:
        return ROT_DIMS[rot_type]
    except KeyError:
        raise ValueError(f"Unknown rot_type: {rot_type}") from None


def rot_rep_to_mat(rot: torch.Tensor, rot_type: str) -> torch.Tensor:
    """Predicted rotation rep -> (B, 3, 3), dispatched on ROT_TYPE
    (`rotations.py:262`)."""
    if rot_type in ("ego_quat", "allo_quat"):
        return quat_to_mat(rot)
    if rot_type in ("ego_log_quat", "allo_log_quat"):
        return quat_to_mat(qexp(rot))
    if rot_type in ("ego_lie_vec", "allo_lie_vec"):
        return lie_vec_to_mat(rot)
    if rot_type in ("ego_rot6d", "allo_rot6d"):
        return rot6d_to_mat(rot)
    raise ValueError(f"Wrong pred_rot type: {rot_type}")
