"""Batched rotation representations on torch tensors.

Counterpart of `catre_tpu/geom/rotations.py`: `normalize` (:16),
`rot6d_to_mat`, `mat_to_rot6d` (:42), `quat_to_mat`, `mat_to_quat` (:75),
`euler_to_mat` (:105), `axangle_to_mat`, `allo_to_ego_mat` (:159), `qexp`,
`lie_vec_to_mat`, `mat_to_lie_vec` (:234), `get_rot_dim`, `rot_rep_to_mat`
(:262) for all eight ROT_TYPEs and `rot_from_axangle_chain` (:282). Same
formulas and branch guards, so the two agree to float rounding on the same
inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`: v / max(||v||, eps)."""
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True), min=eps)


def rot6d_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt; columns [x|y|z]
    (`rotations.py:23`)."""
    x = F.normalize(d6[..., 0:3], dim=-1, eps=1e-12)
    z = F.normalize(torch.linalg.cross(x, d6[..., 3:6], dim=-1), dim=-1, eps=1e-12)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def mat_to_rot6d(rots: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two columns."""
    return torch.cat([rots[..., :, 0], rots[..., :, 1]], dim=-1)


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


def mat_to_quat(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> wxyz quaternion (..., 4), Shepperd's branch picked by the
    largest of (trace, m00, m11, m22) (the first on ties), w >= 0."""
    m = mat
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    cases = torch.stack([
        torch.stack([1.0 + t, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1),
    ], dim=-2)                                                   # (..., 4 cases, 4)
    idx = torch.argmax(torch.stack([t, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cases, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def euler_to_mat(angles: torch.Tensor) -> torch.Tensor:
    """XYZ euler angles in radians (..., 3) -> Rx @ Ry @ Rz (..., 3, 3)
    (`rotations.py:105`), used by the init-pose noise."""
    x, y, z = angles.unbind(-1)
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    shape = angles.shape[:-1] + (3, 3)
    zmat = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], dim=-1).reshape(shape)
    ymat = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], dim=-1).reshape(shape)
    xmat = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], dim=-1).reshape(shape)
    return xmat @ ymat @ zmat


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


def mat_to_lie_vec(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> so(3) vector (..., 3), through the quaternion."""
    q = mat_to_quat(mat)
    w, v = q[..., 0], q[..., 1:]
    sin_half = torch.linalg.norm(v, dim=-1)
    half = torch.arctan2(sin_half, w)
    k = torch.where(sin_half > 1e-8, 2.0 * half / torch.clamp(sin_half, min=1e-12), 2.0)
    return v * k[..., None]


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


def rot_from_axangle_chain(ax_angles) -> torch.Tensor:
    """Rotation composed from a chain of (ax, ay, az, angle / pi), in list
    order (the `canonical` init-pose mode): (3, 3) float32."""
    R = torch.eye(3)
    for ax_angle in ax_angles:
        axis = torch.tensor(ax_angle[:3], dtype=torch.float32)
        angle = torch.tensor(ax_angle[3] * math.pi, dtype=torch.float32)
        R = R @ axangle_to_mat(axis[None], angle[None])[0]
    return R
