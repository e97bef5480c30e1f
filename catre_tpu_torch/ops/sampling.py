"""Ball-crop point sampling on the device: a depth frame's instances -> the
refine's (num_points, 3) clouds.

Counterpart of `catre_tpu/ops/sampling.py`: `ball_inside_mask` (:151),
`select_inside` (:180), `ball_crop_indices` (:122), `crop_ball_from_cloud`
(:214), `_window_origin` (:231), `_window_to_flat_idx` (:241),
`batch_ball_crop` (:248), `batch_ball_crop_from_depth` (:325),
`batch_ball_crop_candidates` (:396), `batch_select_from_candidates` (:447),
`farthest_point_indices` (:471) and `random_sample_indices` (:513). The JAX
module is XLA, with no Pallas kernel; sorts, `topk` and gathers are the port.

Every function is batched over leading dimensions: a whole group of G images
with M instance slots each is one call on (G, M, ...) tensors, the windows
gathered with index grids built from the per-instance origins. The per-image
forms of the JAX functions are the same calls without the G dimension.

Randomness. Each randomized function takes `priorities`, the uniform field
that the JAX function draws (one row per `jax.random.split(key, M)` key of
the image), or draws it with `torch.rand` from the explicit `generator`,
which lies on the inputs' device. Torch's generator is not threefry, so
parity tests hand both packages the same field.

Exactness. The selection follows `lax.top_k(-p)`: ascending priority, ties
to the lower index, through a unique int64 key (float bits << 32 | index;
priorities and BIG are positive, so their bits order as integers). Distances
and the ball radius are the forward FMA chains that XLA computes on the CPU,
emulated in float64 with a correctly rounded result (`fma32`, `sqrt32`), so
the CPU and the card give the same bits, and the same as JAX. Divisors are
tensors on the data's device: CUDA turns division by a CPU scalar into a
multiplication by its reciprocal.

Not ported (ROADMAP item 15): `gather_points_mxu`, `cycle_indices_mxu` and
`_FORCE_MXU_FORM` (:31-119), the TPU's one-hot gathers, are native indexing
here; `selection="packed_sort"` (:189) is dropped.

Under a profiler each image-level crop is two spans: `catre.sampler.candidates`
(the window gathers or the full-frame candidates, and the in-ball mask) and
`catre.sampler.select` (the draw among them and the gathers).
"""

from __future__ import annotations

import torch

from ..utils.profiler import span

CANDIDATES, SELECT = "catre.sampler.candidates", "catre.sampler.select"

BIG = 1e30
MIN_RADIUS = 0.05


# ---- exactly rounded f32 arithmetic, the same bits on the CPU and the card

def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, as a fused multiply-add. The product is
    exact in float64; the float64 sum is rounded to odd (its error found by
    TwoSum), which makes the final rounding to f32 the correct one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root of x >= 0. The library's float64
    root, rounded to f32, is moved to its neighbour where the midpoint
    squared (exact in float64) says so: torch's vectorized CPU `sqrt` is not
    correctly rounded."""
    r = torch.sqrt(x.double()).float()
    xd = x.double()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + down.double()) * 0.5
    r = torch.where(xd > hi * hi, up, r)
    return torch.where(xd < lo * lo, down, r)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """||v|| over the last dimension of size 3 as XLA's CPU reduction
    computes it: sqrt(fma(z, z, fma(y, y, x * x)))."""
    x, y, z = v.unbind(-1)
    return sqrt32(fma32(z, z, fma32(y, y, x * x)))


def ball_radius(pose: torch.Tensor, scale: torch.Tensor, ratio: float) -> torch.Tensor:
    """ratio * ||R @ scale||, (..., 3, 4) and (..., 3) -> (...,): the product
    as XLA's forward FMA chain over the three columns."""
    R = pose[..., :3, :3]
    s = scale[..., None, :]
    v = fma32(R[..., 2], s[..., 2], fma32(R[..., 1], s[..., 1], R[..., 0] * s[..., 0]))
    return _const(ratio, v) * norm3(v)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant on `like`'s device, as a tensor (see the module notes
    on CPU-scalar divisors)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _draw(shape, generator, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("pass `priorities` or an explicit torch.Generator on the inputs' device")
    return torch.rand(shape, generator=generator, device=device)


def _gather_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 3), broadcastable to idx's batch shape; idx (..., P) ->
    (..., P, 3)."""
    pts = pts.expand(*idx.shape[:-1], *pts.shape[-2:])
    return torch.gather(pts, -2, idx[..., None].expand(*idx.shape, 3))


# ---- the ball crop of one candidate field

def ball_inside_mask(pts, valid, center, radius, min_inside: int = 10,
                     growth: float = 1.1, growth_steps: int = 10):
    """Deterministic half of the ball crop: pts (..., N, 3), valid (..., N),
    center (..., 3), radius (...) -> (inside (..., N) bool, n_inside (...)
    int32). Radii radius * growth^k (radius at least 0.05): the first with at
    least `min_inside` points; if none has, the largest if it holds any
    point, else every valid point."""
    dist = norm3(pts - center[..., None, :])
    dist = torch.where(valid, dist, BIG)
    radius = torch.clamp(radius, min=MIN_RADIUS)
    # growth ** k as JAX computes it: f32(growth) raised in f32, correctly rounded
    g = float(torch.tensor(growth, dtype=torch.float32))
    powers = torch.tensor([g ** k for k in range(growth_steps)], dtype=torch.float64)
    radii = radius[..., None] * powers.float().to(radius.device)          # (..., steps)
    counts = torch.stack([(dist <= radii[..., k, None]).sum(-1) for k in range(growth_steps)],
                         dim=-1)
    ok = counts >= min_inside
    k_first = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)       # first True, else 0
    eff = torch.where(ok.any(-1), torch.gather(radii, -1, k_first)[..., 0],
                      torch.where(counts[..., -1] > 0, radii[..., -1], BIG))
    inside = valid & (dist <= eff[..., None])
    return inside, inside.sum(-1).to(torch.int32)


def ascending_first(p: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest of p (..., N) >= 0, ascending, ties to the
    lower position: the order of `lax.top_k(-p, k)`."""
    if p.dtype != torch.float32:
        raise ValueError(f"priorities must be float32 (JAX draws f32), got {p.dtype}")
    pos = torch.arange(p.shape[-1], device=p.device)
    key = (p.contiguous().view(torch.int32).to(torch.int64) << 32) | pos
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def _cycle(idx: torch.Tensor, n: torch.Tensor, num_points: int) -> torch.Tensor:
    """Duplicate-pad: position j >= n takes idx[j % n] (idx[0] when n = 0)."""
    j = torch.arange(num_points, device=idx.device)
    n = n[..., None].to(torch.int64)
    src = torch.where(n > 0, j % torch.clamp(n, min=1), 0).expand_as(idx)
    return torch.where(j < n, idx, torch.gather(idx, -1, src))


def select_inside(inside, n_inside, num_points: int, priorities=None, generator=None):
    """Randomized half of the ball crop: `num_points` positions of the inside
    candidates (..., N), uniform without replacement by priority, cycled
    when fewer qualify -> (..., num_points) int64."""
    if priorities is None:
        priorities = _draw(inside.shape, generator, inside.device)
    p = torch.where(inside, priorities, BIG)
    return _cycle(ascending_first(p, num_points), n_inside, num_points)


def ball_crop_indices(pts, valid, center, radius, num_points: int, min_inside: int = 10,
                      growth: float = 1.1, growth_steps: int = 10, priorities=None,
                      generator=None):
    """`num_points` positions inside the ball -> (idx (..., num_points),
    n_inside (...))."""
    inside, n_inside = ball_inside_mask(pts, valid, center, radius, min_inside, growth,
                                        growth_steps)
    return select_inside(inside, n_inside, num_points, priorities, generator), n_inside


def crop_ball_from_cloud(pts, valid, pose, scale, ratio: float, num_points: int,
                         priorities=None, generator=None):
    """The whole ball crop, radius from the pose and scale estimate: pts
    (..., N, 3), valid (..., N), pose (..., 3, 4), scale (..., 3) ->
    (sampled (..., num_points, 3), idx, n_inside)."""
    idx, n_inside = ball_crop_indices(pts, valid, pose[..., :, 3],
                                      ball_radius(pose, scale, ratio), num_points,
                                      priorities=priorities, generator=generator)
    return _gather_points(pts, idx), idx, n_inside


# ---- windows

def window_origin(r_min, r_max, c_min, c_max, wsh: int, wsw: int, h: int, w: int):
    """Mask-bbox-centred window origin, clamped per dimension (floor
    division, as JAX's `//` on the sentinel bbox (h, -1, w, -1))."""
    r0 = torch.clamp(torch.div(r_min + r_max + 1 - wsh, 2, rounding_mode="floor"), 0, h - wsh)
    c0 = torch.clamp(torch.div(c_min + c_max + 1 - wsw, 2, rounding_mode="floor"), 0, w - wsw)
    return r0, c0


def window_to_flat_idx(idx_w, r0, c0, wsw: int, w: int):
    """Window positions (..., P) -> flat H * W pixel indices, r0 and c0 (...)."""
    return (r0[..., None] + idx_w // wsw) * w + (c0[..., None] + idx_w % wsw)


def _window_sizes(window_size: int, h: int, w: int):
    if window_size <= 0:
        raise ValueError(f"window_size {window_size}: resolve SAMPLE_WINDOW = -1 with "
                         "data.loader.auto_sample_window first; 0 is the full frame")
    return min(int(window_size), h), min(int(window_size), w)


def _window_grid(r0, c0, wsh: int, wsw: int):
    """Row and column index grids (..., wsh, 1) and (..., 1, wsw)."""
    rows = r0[..., None] + torch.arange(wsh, device=r0.device)
    cols = c0[..., None] + torch.arange(wsw, device=c0.device)
    return rows[..., :, None], cols[..., None, :]


def _image_index(g: int, device) -> torch.Tensor:
    return torch.arange(g, device=device)[:, None, None, None]


def _mask_bbox_from_masks(masks):
    """(G, M, H, W) bool -> (r_min, r_max, c_min, c_max), each (G, M); an
    empty mask gives (H, -1, W, -1)."""
    h, w = masks.shape[-2:]
    rows, cols = masks.any(-1), masks.any(-2)
    ridx = torch.arange(h, device=masks.device)
    cidx = torch.arange(w, device=masks.device)
    return (torch.where(rows, ridx, h).amin(-1), torch.where(rows, ridx, -1).amax(-1),
            torch.where(cols, cidx, w).amin(-1), torch.where(cols, cidx, -1).amax(-1))


# ---- depth frames and mask words

def mask_words(packed: torch.Tensor) -> torch.Tensor:
    """Bit-packed mask words with an arithmetic shift that keeps bit i:
    uint16 / uint32 become int16 / int32 views (torch shifts no wider
    unsigned type); uint8, int16, int32 and a bool stack pass."""
    if packed.dtype == torch.uint16:
        return packed.view(torch.int16)
    if packed.dtype == torch.uint32:
        return packed.view(torch.int32)
    return packed


def depth_metres(depth: torch.Tensor) -> torch.Tensor:
    """u16 millimetres (uint16, or its int16 view) -> f32 metres,
    f32(mm) / 1000 exactly rounded; f32 metres pass."""
    if depth.dtype in (torch.uint16, torch.int16):
        mm = depth.view(torch.int16).to(torch.int32) & 0xFFFF
        return mm.to(torch.float32) / _const(1000.0, depth)
    return depth


def unpack_masks(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(G, H, W) words -> (G, m, H, W) bool, bit i = instance i; a (G, M, H,
    W) bool stack passes."""
    packed = mask_words(packed)
    if packed.dtype == torch.bool:
        return packed
    bits = torch.arange(m, dtype=packed.dtype, device=packed.device)[None, :, None, None]
    return ((packed[:, None] >> bits) & 1).bool()


def _group(*tensors):
    """Add the image dimension to per-image inputs."""
    return [t.unsqueeze(0) for t in tensors]


def _squeeze(outputs, per_image: bool):
    return tuple(o.squeeze(0) for o in outputs) if per_image else tuple(outputs)


# ---- the image-level crops

def batch_ball_crop(cloud, masks, poses, scales, ratio: float, num_points: int,
                    fps_sample: bool = False, window_size: int = 0, priorities=None,
                    generator=None):
    """Per-instance ball crop over organized clouds.

    cloud (H, W, 3), masks (M, H, W) bool, poses (M, 3, 4), scales (M, 3), or
    each with a leading image dimension G. `window_size` > 0 (and no FPS):
    each instance's candidates are a window centred on its own mask bbox,
    reduced here from the masks. `fps_sample`: 4 x num_points in-ball
    candidates, then farthest-point sampling among them. `priorities`: (M, n)
    per image, n the window's or the frame's pixels.

    Returns (pcls (M, num_points, 3), idx (M, num_points) flat H * W pixel
    indices, n_inside (M,)), with G in front for group inputs.
    """
    per_image = cloud.dim() == 3
    if per_image:
        cloud, masks, poses, scales = _group(cloud, masks, poses, scales)
        priorities = None if priorities is None else priorities.unsqueeze(0)
    g, h, w = cloud.shape[:3]
    windowed = bool(window_size) and not fps_sample and (window_size < h or window_size < w)
    with span(CANDIDATES):
        if windowed:
            wsh, wsw = _window_sizes(window_size, h, w)
            r_min, r_max, c_min, c_max = _mask_bbox_from_masks(masks)
            r0, c0 = window_origin(r_min, r_max, c_min, c_max, wsh, wsw, h, w)
            rows, cols = _window_grid(r0, c0, wsh, wsw)
            gi = _image_index(g, cloud.device)
            mi = torch.arange(masks.shape[1], device=cloud.device)[None, :, None, None]
            pts = cloud[gi, rows, cols].flatten(-3, -2)                    # (G, M, n, 3)
            valid = masks[gi, mi, rows, cols].flatten(-2) & (pts[..., 2] > 0)
        else:
            pts = cloud.reshape(g, 1, h * w, 3)
            valid = masks.flatten(-2) & (pts[..., 2] > 0)
        inside, n_in = ball_inside_mask(pts, valid, poses[..., :, 3],
                                        ball_radius(poses, scales, ratio))
    with span(SELECT):
        if not fps_sample:
            idx = select_inside(inside, n_in, num_points, priorities, generator)
            sampled = _gather_points(pts, idx)
            if windowed:
                idx = window_to_flat_idx(idx, r0, c0, wsw, w)
            return _squeeze((sampled, idx, n_in), per_image)
        n_cand = 4 * num_points
        cand_idx = select_inside(inside, n_in, n_cand, priorities, generator)
        cand = _gather_points(pts, cand_idx)
        cand_valid = (torch.arange(n_cand, device=cand.device)
                      < torch.clamp(n_in, max=n_cand)[..., None])
        fps_idx = farthest_point_indices(cand, num_points, valid=cand_valid)
        return _squeeze((_gather_points(cand, fps_idx), torch.gather(cand_idx, -1, fps_idx),
                         n_in), per_image)


def batch_ball_crop_candidates(depth, K, packed, mask_bbox, poses, scales, ratio: float,
                               window_size: int):
    """Deterministic half of `batch_ball_crop_from_depth`: each instance's
    window of the raw frame, converted and backprojected in place (the f32 op
    order of `geom.transforms.backproject`), and its in-ball mask.

    depth (H, W) u16 millimetres (uint16 or its int16 view) or f32 metres; K
    (3, 3); packed (H, W) mask word (bit i = instance i; uint8 / 16 / 32 or
    their signed views) or the (M, H, W) bool stack; mask_bbox (M, 4) int
    (r_min, r_max, c_min, c_max), empty slots (H, -1, W, -1); poses (M, 3,
    4); scales (M, 3); each with a leading G for a group.

    Returns (pts (M, n, 3) f32, inside (M, n) bool, n_inside (M,) int32,
    origin (M, 2) window origins), n = wsh * wsw.
    """
    per_image = depth.dim() == 2
    if per_image:
        depth, K, packed, mask_bbox, poses, scales = _group(depth, K, packed, mask_bbox,
                                                            poses, scales)
    packed = mask_words(packed)
    g, h, w = depth.shape
    m = poses.shape[1]
    wsh, wsw = _window_sizes(window_size, h, w)
    mask_bbox = mask_bbox.to(torch.int64)
    r0, c0 = window_origin(mask_bbox[..., 0], mask_bbox[..., 1], mask_bbox[..., 2],
                           mask_bbox[..., 3], wsh, wsw, h, w)
    rows, cols = _window_grid(r0, c0, wsh, wsw)
    gi = _image_index(g, depth.device)
    mi = torch.arange(m, device=depth.device)[None, :, None, None]
    dw = depth_metres(depth[gi, rows, cols])                                # (G, M, wsh, wsw)
    if packed.dtype == torch.bool:
        mask_w = packed[gi, mi, rows, cols]
    else:
        mask_w = ((packed[gi, rows, cols] >> mi.to(packed.dtype)) & 1).bool()
    K = K.to(dw.dtype)
    fx, fy = K[:, 0, 0, None, None, None], K[:, 1, 1, None, None, None]
    cx, cy = K[:, 0, 2, None, None, None], K[:, 1, 2, None, None, None]
    vy = rows.to(dw.dtype) - cy
    vx = cols.to(dw.dtype) - cx
    pts = torch.stack([vx * dw / fx, vy * dw / fy, dw], dim=-1).flatten(-3, -2)
    valid = mask_w.flatten(-2) & (pts[..., 2] > 0)
    inside, n_inside = ball_inside_mask(pts, valid, poses[..., :, 3],
                                        ball_radius(poses, scales, ratio))
    return _squeeze((pts, inside, n_inside, torch.stack([r0, c0], dim=-1)), per_image)


def batch_select_from_candidates(pts, inside, n_inside, origin, num_points: int, img_w: int,
                                 wsw: int, priorities=None, generator=None):
    """Randomized half over precomputed candidates: pts (..., n, 3), inside
    (..., n), n_inside (...), origin (..., 2) -> the `batch_ball_crop`
    contract. With the same priorities, composing the two halves gives
    exactly `batch_ball_crop_from_depth`."""
    idx_w = select_inside(inside, n_inside, num_points, priorities, generator)
    idx = window_to_flat_idx(idx_w, origin[..., 0], origin[..., 1], wsw, img_w)
    return _gather_points(pts, idx_w), idx, n_inside


def batch_ball_crop_from_depth(depth, K, packed, mask_bbox, poses, scales, ratio: float,
                               num_points: int, window_size: int, priorities=None,
                               generator=None):
    """Windowed ball crop straight from the raw frame (arguments of
    `batch_ball_crop_candidates`): no full-frame cloud, unpacked masks or
    full-frame bbox reduction. Equal to `batch_ball_crop(..., window_size)`
    on `backproject(depth_metres(depth), K)` and the unpacked masks."""
    with span(CANDIDATES):
        pts, inside, n_inside, origin = batch_ball_crop_candidates(
            depth, K, packed, mask_bbox, poses, scales, ratio, window_size)
    wsw = _window_sizes(window_size, *depth.shape[-2:])[1]
    with span(SELECT):
        return batch_select_from_candidates(pts, inside, n_inside, origin, num_points,
                                            depth.shape[-1], wsw, priorities, generator)


# ---- farthest-point and plain random sampling

def farthest_point_indices(pts: torch.Tensor, num_points: int, start_from_mean: bool = True,
                           valid: torch.Tensor | None = None) -> torch.Tensor:
    """Farthest point sampling over pts (..., M, 3) -> (..., num_points)
    int64; the first point the farthest from the centroid, invalid points
    never chosen (the first maximum on ties, as `jnp.argmax`)."""
    neg = torch.tensor(-torch.inf, device=pts.device)
    if valid is not None:
        vmask = valid.bool()
        n_valid = torch.clamp(vmask.sum(-1), min=1).to(pts.dtype)
        centroid = torch.where(vmask[..., None], pts, 0.0).sum(-2) / n_valid[..., None]
    else:
        vmask = None
        centroid = pts.mean(-2)
    if start_from_mean:
        d0 = norm3(pts - centroid[..., None, :])
        if vmask is not None:
            d0 = torch.where(vmask, d0, neg)
        last = torch.argmax(d0, dim=-1)
    else:
        last = torch.zeros(pts.shape[:-2], dtype=torch.int64, device=pts.device)
    chosen = [last]
    min_dist = torch.full(pts.shape[:-1], torch.inf, dtype=pts.dtype, device=pts.device)
    for _ in range(1, num_points):
        d = norm3(pts - _gather_points(pts, last[..., None]))
        min_dist = torch.minimum(min_dist, d)
        cand = min_dist if vmask is None else torch.where(vmask, min_dist, neg)
        last = torch.argmax(cand, dim=-1)
        chosen.append(last)
    return torch.stack(chosen, dim=-1)


def random_sample_indices(n_candidates: int, num_points: int, n_valid=None, priorities=None,
                          generator=None, device="cpu") -> torch.Tensor:
    """Uniform sample without replacement (randperm[:k]) over the first
    `n_valid` of `n_candidates` positions, cycling when fewer than
    `num_points` -> (num_points,) int64. `priorities`: (n_candidates,)."""
    if priorities is None:
        priorities = _draw((n_candidates,), generator, device)
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, device=priorities.device)
        pos = torch.arange(n_candidates, device=priorities.device)
        priorities = torch.where(pos < n_valid, priorities, BIG)
    idx = ascending_first(priorities, num_points)
    if n_valid is not None:
        j = torch.arange(num_points, device=idx.device)
        wrap = j % torch.clamp(n_valid, min=1)
        idx = torch.where(j < n_valid, idx, idx[wrap])
    return idx
