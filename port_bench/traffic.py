"""The one generator of the benchmark's inputs, read from a cell's traffic
file and made on the device from `--seed`.

Frames (`kind: frames`): depth frames as a detector hands them to CATRE's
test path, drawn the way the port's `entry.example_frames` draws its own: a
tilted background at 1.2-1.6 m, `objs` ellipsoidal bumps of `size_px` axes at
0.6-1.1 m (the nearer one owns a pixel), `hole_share` of the pixels without
depth, NOCS-REAL intrinsics; each real slot has its mask, its mask's bounds,
a class, an init pose near its backprojected centre (a random rotation, 1 cm
of noise) and an init size near its extent; the other slots of
`slots_per_frame` are padded as a loader pads them (empty mask, bounds (H, -1,
W, -1), identity at 1 m, size 0.1).

Batches (`kind: batches`): training rows as `entry.train_batch` makes them:
an anisotropically scaled canonical shape (the keypoints) posed in the
camera frame (the cloud), every third object y-symmetric, every row valid.

Every seed draws the same sizes: the counts of frames, slots and rows are
the file's, and each group's frames hold objs[0], objs[0] + 1, ..., objs[1]
objects in turn, in an order drawn from the seed, so that every call
refines the same number of real objects; only the values differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

REAL_K = ((591.0125, 0.0, 322.525), (0.0, 590.16775, 244.11084), (0.0, 0.0, 1.0))
_SALT = 0x7AFF1C


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence((int(seed), _SALT, stream)).generate_state(1, np.uint64)[0])
        % (2 ** 63))


def euler_to_mat(a: torch.Tensor) -> torch.Tensor:
    x, y, z = a.unbind(-1)
    c, s = torch.cos, torch.sin
    o, n = torch.ones_like(x), torch.zeros_like(x)
    shape = a.shape[:-1] + (3, 3)
    rz = torch.stack([c(z), -s(z), n, s(z), c(z), n, n, n, o], -1).reshape(shape)
    ry = torch.stack([c(y), n, s(y), n, o, n, -s(y), n, c(y)], -1).reshape(shape)
    rx = torch.stack([o, n, n, n, c(x), -s(x), n, s(x), c(x)], -1).reshape(shape)
    return rx @ ry @ rz


def _u(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def make_frames(t: dict, g: int, gen: torch.Generator, device) -> dict:
    """g frames of traffic `t` on `device`: depth (g, H, W) int16 mm, packed
    (g, H, W) uint8 (bit j: slot j's mask), mask_bbox (g, M, 4) int32, K (g,
    3, 3), poses (g, M, 3, 4), scales (g, M, 3), classes (g, M) int64, n_objs
    (g,) int64, bbox_size (g, M): the larger side of each real slot's box."""
    h, w, m = t["height"], t["width"], t["slots_per_frame"]
    K = torch.tensor(REAL_K, device=device)
    K[0] *= w / 640.0
    K[1, 1:] *= h / 480.0
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rows = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    lo, hi = t["objs"]
    counts = lo + torch.arange(g, device=device) % (hi - lo + 1)
    n_objs = counts[torch.randperm(g, generator=gen, device=device)]
    real = torch.arange(m, device=device)[None, :] < n_objs[:, None]                 # (g, m)
    bg = (_u(gen, (g, 1, 1), 1.2, 1.6, device)
          + _u(gen, (g, 1, 1), -0.1, 0.1, device) * (rows / h - 0.5)
          + _u(gen, (g, 1, 1), -0.1, 0.1, device) * (cols / w - 0.5))             # (g, h, w)
    ay = _u(gen, (g, m), *t["size_px"], device) / 2
    ax = _u(gen, (g, m), *t["size_px"], device) / 2
    oy, ox = _u(gen, (g, m), 0.0, h, device), _u(gen, (g, m), 0.0, w, device)
    zc = _u(gen, (g, m), 0.6, 1.1, device)
    bumps = []
    for j in range(m):
        q = ((rows - oy[:, j, None, None]) / ay[:, j, None, None]) ** 2 + \
            ((cols - ox[:, j, None, None]) / ax[:, j, None, None]) ** 2
        bump = zc[:, j, None, None] - ax[:, j, None, None] * zc[:, j, None, None] / fx \
            * torch.sqrt(torch.clamp(1.0 - q, 0.0, 1.0))
        bumps.append(torch.where((q < 1.0) & real[:, j, None, None], bump, torch.inf))
    z, owner = torch.stack([bg] + bumps, 1).min(dim=1)                             # (g, h, w)
    owner = owner - 1
    depth = torch.round(z * 1000.0)
    depth = torch.where(torch.rand(depth.shape, generator=gen, device=device)
                        < t["hole_share"], 0.0, depth).to(torch.int16)
    slot = torch.arange(m, device=device)
    masks = owner[:, None] == slot[None, :, None, None]                            # (g, m, h, w)
    packed = (masks.to(torch.uint8) << slot.to(torch.uint8)[None, :, None, None]).sum(
        1, dtype=torch.uint8)
    r_any, c_any = masks.any(-1), masks.any(-2)
    r_idx = torch.arange(h, device=device)
    c_idx = torch.arange(w, device=device)
    bbox = torch.stack([
        torch.where(r_any, r_idx, h).amin(-1), torch.where(r_any, r_idx, -1).amax(-1),
        torch.where(c_any, c_idx, w).amin(-1), torch.where(c_any, c_idx, -1).amax(-1)], -1)
    t_est = torch.stack([(ox - cx) / fx * zc, (oy - cy) / fy * zc, zc], -1) \
        + 0.01 * torch.randn((g, m, 3), generator=gen, device=device)
    R = euler_to_mat(_u(gen, (g, m, 3), -math.pi, math.pi, device))
    ext = torch.stack([2 * ax * zc / fx, 2 * ay * zc / fy, 2 * ax * zc / fx], -1)
    s_est = ext * _u(gen, (g, m, 3), 0.9, 1.1, device)
    eye = torch.eye(3, 4, device=device).expand(g, m, 3, 4).clone()
    eye[..., 2, 3] = 1.0
    poses = torch.where(real[..., None, None], torch.cat([R, t_est[..., None]], -1), eye)
    scales = torch.where(real[..., None], s_est, 0.1)
    classes = torch.randint(0, t["classes"], (g, m), generator=gen, device=device)
    x1, x2 = torch.clamp(ox - ax, min=0.0), torch.clamp(ox + ax, max=w - 1.0)
    y1, y2 = torch.clamp(oy - ay, min=0.0), torch.clamp(oy + ay, max=h - 1.0)
    return {"depth": depth, "packed": packed, "mask_bbox": bbox.to(torch.int32),
            "K": K.expand(g, 3, 3).contiguous(), "poses": poses.contiguous(),
            "scales": scales.contiguous(), "classes": torch.where(real, classes, 0),
            "n_objs": n_objs,
            "bbox_size": torch.where(real, torch.maximum(x2 - x1, y2 - y1), 0.0)}


def make_kps_table(t: dict, num_kps: int, gen: torch.Generator, device) -> torch.Tensor:
    """(classes, num_kps, 3) mean-shape keypoints of unit extent."""
    pts = torch.randn((t["classes"], num_kps, 3), generator=gen, device=device)
    return pts / pts.abs().amax(dim=(1, 2), keepdim=True) / 2


def make_batch(b: int, num_pcl: int, num_kps: int, gen: torch.Generator, device) -> dict:
    """One training batch of b rows."""
    canonical = torch.randn((b, max(num_pcl, num_kps), 3), generator=gen, device=device)
    canonical = canonical / (canonical.abs().amax(dim=(1, 2), keepdim=True) * 2)
    scale = _u(gen, (b, 3), 0.1, 0.3, device)
    R = euler_to_mat(_u(gen, (b, 3), -math.pi, math.pi, device))
    t = torch.stack([_u(gen, (b,), -0.2, 0.2, device), _u(gen, (b,), -0.2, 0.2, device),
                     _u(gen, (b,), 0.6, 1.2, device)], 1)
    pcl = torch.einsum("bij,bpj->bpi", R, canonical[:, :num_pcl] * scale[:, None]) + t[:, None]
    K = torch.tensor(((591.0, 0, 322.5), (0, 590.2, 244.1), (0, 0, 1)), device=device)
    return {"pcl": pcl.contiguous(), "obj_kps": canonical[:, :num_kps].contiguous(),
            "obj_pose": torch.cat([R, t[:, :, None]], 2).contiguous(), "obj_scale": scale,
            "obj_mean_scales": scale.clone(), "K": K.expand(b, 3, 3).contiguous(),
            "sym_flag": torch.arange(b, device=device) % 3 == 0,
            "valid": torch.ones(b, dtype=torch.bool, device=device)}
