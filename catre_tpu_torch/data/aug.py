"""Train-time pose, scale and point-cloud augmentation.

Counterpart of `catre_tpu/data/aug.py`: `aug_poses_normal` (:27),
`aug_scale_normal` (:63), `aug_3d_bbox` (:77), `aug_rt` (:103),
`maybe_apply` (:134), `add_noise_depth` (:146) and `aug_depth` (:155). The
JAX package draws from a PRNG key; here the pose, scale and cloud draws come
from an explicit CPU `torch.Generator` and move to the data's device, and the
depth draws come from a generator on the depth's device (the group sampler
runs them on the card). The two packages give different numbers, so each
function keeps the JAX override arguments, through which a test drives both
packages with the same draw.
"""

from __future__ import annotations

import torch

from ..geom.rotations import euler_to_mat


def _choose_row(generator: torch.Generator, options, ndim: int) -> torch.Tensor:
    """One row of an (N, ...) option ladder (at least `ndim` dims), drawn
    uniformly."""
    options = torch.as_tensor(options, dtype=torch.float32)
    options = torch.atleast_1d(options) if ndim == 1 else torch.atleast_2d(options)
    return options[int(torch.randint(options.shape[0], (), generator=generator))]


def _normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator).to(like.device, like.dtype)


def _given(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype).to(like.device)


def aug_poses_normal(generator, poses, std_rot, std_trans, max_rot: float = 45.0,
                     min_z: float = 0.1, euler_deg_override=None, trans_noise_override=None):
    """Euler-angle (degrees, clipped to max_rot) and translation noise on gt
    poses (B, 3, 4); one std of each ladder per call; z kept >= min_z."""
    bs = poses.shape[0]
    if euler_deg_override is not None:
        euler_deg = _given(euler_deg_override, poses)
    else:
        sel = _choose_row(generator, std_rot, 1)
        euler_deg = _normal(generator, (bs, 3), poses) * float(sel)
    rot_noise = euler_to_mat(torch.deg2rad(torch.clamp(euler_deg, -max_rot, max_rot)))
    if trans_noise_override is not None:
        trans_noise = _given(trans_noise_override, poses)
    else:
        sel = _choose_row(generator, std_trans, 2)
        trans_noise = _normal(generator, (bs, 3), poses) * sel.to(poses.device)[None, :]
    r_aug = rot_noise @ poses[:, :3, :3]
    t_aug = poses[:, :3, 3] + trans_noise
    t_aug = torch.cat([t_aug[:, :2], torch.clamp(t_aug[:, 2:], min=max(min_z, 1e-4))], dim=1)
    return torch.cat([r_aug, t_aug[:, :, None]], dim=-1)


def aug_scale_normal(generator, scales, std_scale, min_s: float = 0.04, max_s: float = 0.45,
                     noise_override=None):
    """Gaussian noise on gt scales (B, 3), one std row of the ladder per call,
    clipped to [min_s, max_s]."""
    if noise_override is not None:
        noise = _given(noise_override, scales)
    else:
        sel = _choose_row(generator, std_scale, 2)
        noise = _normal(generator, scales.shape, scales) * sel.to(scales.device)[None, :]
    return torch.clamp(scales + noise, max(min_s, 1e-4), max_s)


def aug_3d_bbox(generator, pcl, pose, scale, sym_flags, shift_min: float = 0.8,
                shift_max: float = 1.2, ratios_e=None):
    """Anisotropic object-frame rescale of the cloud and the gt scale: one
    (ex, ey, ez) draw per batch, y-symmetric samples averaging ex and ez.
    -> (pcl, scale)."""
    if ratios_e is not None:
        e = _given(ratios_e, pcl)
    else:
        e = (torch.rand(3, generator=generator) * (shift_max - shift_min) + shift_min).to(
            pcl.device, pcl.dtype)
    exz = (e[0] + e[2]) / 2.0
    ratios = torch.where(sym_flags[:, None], torch.stack([exz, e[1], exz])[None, :], e[None, :])
    R, t = pose[:, :3, :3], pose[:, :3, 3]
    local = torch.einsum("bji,bpj->bpi", R, pcl - t[:, None, :]) * ratios[:, None, :]
    return torch.einsum("bij,bpj->bpi", R, local) + t[:, None, :], scale * ratios


def aug_rt(generator, pcl, pose, shift_t=(0.005, 0.005, 0.025), shift_rot: float = 15.0,
           rxyz_deg=None, dt_override=None):
    """One rigid perturbation per batch, dR = Rz Ry Rx, applied to the cloud
    and the gt pose: p -> dR (p + dt). -> (pcl, pose)."""
    if rxyz_deg is not None:
        rxyz = _given(rxyz_deg, pcl)
    else:
        rxyz = (torch.rand(3, generator=generator) * (2 * shift_rot) - shift_rot).to(
            pcl.device, pcl.dtype)
    if dt_override is not None:
        dt = _given(dt_override, pcl)
    else:
        shift = torch.as_tensor(shift_t, dtype=torch.float32)
        dt = (torch.rand(3, generator=generator) * (2 * shift) - shift).to(pcl.device, pcl.dtype)
    c, s = torch.cos(torch.deg2rad(rxyz)), torch.sin(torch.deg2rad(rxyz))
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    rx = torch.stack([one, zero, zero, zero, c[0], -s[0], zero, s[0], c[0]]).reshape(3, 3)
    ry = torch.stack([c[1], zero, s[1], zero, one, zero, -s[1], zero, c[1]]).reshape(3, 3)
    rz = torch.stack([c[2], -s[2], zero, s[2], c[2], zero, zero, zero, one]).reshape(3, 3)
    d_r = rz @ ry @ rx
    pcl_aug = torch.einsum("ij,bpj->bpi", d_r, pcl + dt[None, None, :])
    r_aug = torch.einsum("ij,bjk->bik", d_r, pose[:, :3, :3])
    t_aug = torch.einsum("ij,bj->bi", d_r, pose[:, :3, 3] + dt[None, :])
    return pcl_aug, torch.cat([r_aug, t_aug[:, :, None]], dim=-1)


def maybe_apply(generator, prob: float, fn, old_values: tuple, *fn_args):
    """With probability `prob` (one coin for the whole batch) `fn(generator,
    *fn_args)`, else `old_values`."""
    if float(torch.rand((), generator=generator)) < prob:
        return fn(generator, *fn_args)
    return old_values


def _field(draw, generator, shape, like: torch.Tensor, normal: bool) -> torch.Tensor:
    """A given draw on `like`'s device, else one drawn there from `generator`."""
    if draw is not None:
        return _given(draw, like)
    if generator is None:
        raise ValueError("pass the depth draws or an explicit torch.Generator on the "
                         "depth's device")
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, device=like.device, dtype=like.dtype)


def add_noise_depth(depth: torch.Tensor, level: float = 0.005, generator=None,
                    level_draw=None, noise_draw=None) -> torch.Tensor:
    """N(0, lvl) on the pixels > 0 of depth (..., H, W), lvl ~ U(0, level)
    per image: `level_draw` (...,) is lvl itself, `noise_draw` (..., H, W)
    the standard normal field."""
    lvl = (_given(level_draw, depth) if level_draw is not None
           else _field(None, generator, depth.shape[:-2], depth, False) * level)
    noise = _field(noise_draw, generator, depth.shape, depth, True) * lvl[..., None, None]
    return torch.where(depth > 0, depth + noise, depth)


def aug_depth(depth: torch.Tensor, generator=None, drop_depth_prob: float = 0.5,
              drop_depth_ratio: float = 0.2, add_noise_depth_prob: float = 0.9,
              add_noise_depth_level: float = 0.005, fill_draw=None, drop_coin_draw=None,
              keep_draw=None, noise_coin_draw=None, noise_level_draw=None,
              noise_draw=None) -> torch.Tensor:
    """Train-phase depth augmentation of depth (..., H, W) in metres, one
    set of coins per image, in order: zero pixels filled with N(0, 0.1);
    with prob drop_depth_prob a drop_depth_ratio share of all pixels zeroed
    (kept where U(0, 1) > ratio); with prob add_noise_depth_prob
    `add_noise_depth`. The draws of the JAX function's five keys, each
    overridable: `fill_draw` (..., H, W) normal, `drop_coin_draw` (...,)
    uniform, `keep_draw` (..., H, W) uniform, `noise_coin_draw` (...,)
    uniform, and the noise key's two, `noise_level_draw` (...,) in [0, level)
    and `noise_draw` (..., H, W) normal."""
    images = depth.shape[:-2]
    fill = _field(fill_draw, generator, depth.shape, depth, True)
    depth = torch.where(depth == 0, 0.1 * fill, depth)
    do_drop = _field(drop_coin_draw, generator, images, depth, False) < drop_depth_prob
    keep = _field(keep_draw, generator, depth.shape, depth, False) > drop_depth_ratio
    depth = torch.where(do_drop[..., None, None] & ~keep, 0.0, depth)
    do_noise = _field(noise_coin_draw, generator, images, depth, False) < add_noise_depth_prob
    noisy = add_noise_depth(depth, add_noise_depth_level, generator, noise_level_draw,
                            noise_draw)
    return torch.where(do_noise[..., None, None], noisy, depth)
