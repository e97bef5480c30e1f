"""The judge of a sampled cloud, in plain PyTorch, float64.

CATRE's test-time crop of an object's observed cloud: the pixels of its
instance mask with a depth reading, backprojected with the camera's K, those
within a ball around the estimated centre (radius DEPTH_SAMPLE_BALL_RATIO x
the norm of the rotated estimated size, at least 5 cm, grown by 10% up to 9
times until 10 points fall inside; every valid point when none does), and
NUM_PCL of them drawn without replacement, repeated in order when fewer
qualify. The draw itself is random, so this file judges what was drawn
rather than drawing again: every sampled pixel must lie in the mask, read a
depth, lie inside the ball and carry its own backprojection; the distinct
pixels must number min(inside, NUM_PCL) and the rest must cycle them. A
point that sits on the ball's edge within `EDGE` of the radius may count
either way (the program rounds in float32).
"""

from __future__ import annotations

import torch

EDGE = 1e-5                 # relative band around the ball's radius
POINT_RTOL = 2e-6           # a backprojected point, float32 against float64
MIN_RADIUS, MIN_INSIDE, GROWTH, GROWTH_STEPS = 0.05, 10, 1.1, 10


def object_faults(depth_mm, K, mask, pose, scale, ratio, pcl, idx, n_inside) -> list:
    """What is wrong with one object's sampled cloud: depth_mm (H, W), K (3,
    3), mask (H, W) bool, pose (3, 4), scale (3,) as given to the program;
    pcl (P, 3), idx (P,) flat pixels and n_inside as it returned them. ->
    a list of faults, empty when the cloud is sound."""
    depth_mm, K, pose, scale = (t.double() for t in (depth_mm, K, pose, scale))
    h, w = depth_mm.shape
    z = depth_mm / 1000.0
    rows = torch.arange(h, device=z.device, dtype=z.dtype)[:, None].expand(h, w)
    cols = torch.arange(w, device=z.device, dtype=z.dtype)[None, :].expand(h, w)
    pts = torch.stack([(cols - K[0, 2]) * z / K[0, 0], (rows - K[1, 2]) * z / K[1, 1], z], -1)
    pts = pts.reshape(-1, 3)
    valid = (mask & (z > 0)).reshape(-1)
    dist = torch.linalg.norm(pts - pose[:, 3], dim=-1)
    radius = max(ratio * float(torch.linalg.norm(pose[:, :3] @ scale)), MIN_RADIUS)
    counts = [int(((dist <= radius * GROWTH ** k) & valid).sum()) for k in range(GROWTH_STEPS)]
    ok = [k for k, c in enumerate(counts) if c >= MIN_INSIDE]
    if ok:
        eff = radius * GROWTH ** ok[0]
    elif counts[-1] > 0:
        eff = radius * GROWTH ** (GROWTH_STEPS - 1)
    else:
        eff = float("inf")
    lo, hi = valid & (dist <= eff * (1 - EDGE)), valid & (dist <= eff * (1 + EDGE))
    n, n_pts = int(n_inside), idx.shape[0]
    faults = []
    if not int(lo.sum()) <= n <= int(hi.sum()):
        faults.append(f"{n} points inside, the ball holds {int(lo.sum())}-{int(hi.sum())}")
    if n == 0:
        return faults
    idx = idx.long()
    if bool(((idx < 0) | (idx >= h * w)).any()):
        return faults + ["a pixel index outside the frame"]
    if not bool(hi[idx].all()):
        faults.append(f"{int((~hi[idx]).sum())} points outside the mask, the depth or the ball")
    k = min(n, n_pts)
    if idx[:k].unique().numel() != k:
        faults.append("the first min(inside, NUM_PCL) points repeat")
    j = torch.arange(n_pts, device=idx.device)
    if not torch.equal(idx, idx[j % n]):
        faults.append("the points past the inside count do not cycle")
    ref = pts[idx]
    err = (pcl.double() - ref).norm(dim=-1)
    if bool((err > POINT_RTOL * ref.norm(dim=-1) + 1e-9).any()):
        faults.append(f"a point {float(err.max()):.3e} m from its pixel's backprojection")
    return faults
