"""Debug drawing: projected 3D boxes, depth as a JET heat map, panels tiled
into one image.

Counterpart of `catre_tpu/utils/vis.py` (`draw_projected_box3d` :23,
`draw_projected_kps` :42, `heatmap` :66, `grid_show` :79), which draws with
OpenCV and tiles with matplotlib; the card's host has neither, so this is
numpy: lines are sampled at every pixel step and widened to `thickness`,
keypoints are the five-pixel dot that `cv2.circle(img, (u, v), 0, color, 2)`
paints, the JET map is the piecewise-linear one OpenCV tabulates (within 1
level of `cv2.COLORMAP_JET`), and `grid_show` writes the tiled panels with
`data/png.py`. Panel titles are not rendered.
"""

from __future__ import annotations

import numpy as np

from ..data import png
from ..eval.nocs_eval import get_3d_bbox

# the 8 corners of get_3d_bbox, the box's 12 edges
_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),  # +y face
    (4, 5), (4, 6), (5, 7), (6, 7),  # -y face
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
]


def project(points: np.ndarray, K: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """(N, 3) object points under pose (3, 4) through K -> (N, 2) pixels."""
    cam = np.asarray(points, np.float64) @ np.asarray(pose, np.float64)[:, :3].T \
        + np.asarray(pose, np.float64)[:, 3]
    uvw = cam @ np.asarray(K, np.float64).T
    return uvw[:, :2] / uvw[:, 2:3]


def _stamp(img: np.ndarray, us: np.ndarray, vs: np.ndarray, color, thickness: int) -> None:
    """Paint the pixels within a thickness-wide square of each (u, v)."""
    h, w = img.shape[:2]
    r = max(int(thickness), 1) // 2
    for du in range(-r, max(int(thickness), 1) - r):
        for dv in range(-r, max(int(thickness), 1) - r):
            u, v = us + du, vs + dv
            ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            img[v[ok], u[ok]] = color


def _clip(p0, p1, w: int, h: int):
    """The part of segment p0-p1 inside [0, w-1] x [0, h-1] (Liang-Barsky),
    or None."""
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0), (dx, w - 1 - x0), (-dy, y0), (dy, h - 1 - y0)):
        if p == 0:
            if q < 0:
                return None
        elif p < 0:
            t0 = max(t0, q / p)
        else:
            t1 = min(t1, q / p)
    if t0 > t1:
        return None
    return (x0 + t0 * dx, y0 + t0 * dy), (x0 + t1 * dx, y0 + t1 * dy)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """A straight line from p0 to p1 (pixel coordinates) in place, clipped
    to the image, one sample a pixel step."""
    if not (np.all(np.isfinite(p0)) and np.all(np.isfinite(p1))):
        return
    seg = _clip(tuple(map(float, p0)), tuple(map(float, p1)), img.shape[1], img.shape[0])
    if seg is None:
        return
    (u0, v0), (u1, v1) = np.round(seg[0]), np.round(seg[1])
    t = np.linspace(0.0, 1.0, int(max(abs(u1 - u0), abs(v1 - v0))) + 1)
    _stamp(img, np.round(u0 + t * (u1 - u0)).astype(np.int64),
           np.round(v0 + t * (v1 - v0)).astype(np.int64), color, thickness)


def draw_projected_box3d(image: np.ndarray, scale, pose, K, color=(0, 255, 0),
                         thickness: int = 2) -> np.ndarray:
    """The scale-sized 3D box under pose (3, 4), projected through K, drawn
    onto a copy of image (H, W, 3) uint8 in the image's channel order."""
    uv = project(get_3d_bbox(scale).T, K, pose)
    img = np.array(image, copy=True)
    for a, b in _EDGES:
        draw_line(img, uv[a], uv[b], color, thickness)
    return img


# the pixels of `cv2.circle(img, (u, v), 0, color, 2)` around (u, v): a plus
_DOT = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def draw_projected_kps(image: np.ndarray, kps: np.ndarray, scale, pose, K,
                       color=(0, 0, 255)) -> np.ndarray:
    """Normalized keypoints (N, 3) times scale (3,), under pose (3, 4) and
    projected through K, drawn as dots onto a copy of image (H, W, 3) uint8
    (the training vis, `engine.py:388-422`). A dot whose centre rounds to a
    pixel of the image is painted, clipped to it; the JAX package draws into
    the image it is given, the port into a copy."""
    pts = np.asarray(kps, np.float32) * np.asarray(scale, np.float32)[None]
    uv = project(pts, K, pose)
    img = np.array(image, copy=True)
    h, w = img.shape[:2]
    ok = np.all(np.isfinite(uv), axis=1)
    us, vs = np.round(uv[ok]).astype(np.int64).T
    inside = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
    us, vs = us[inside], vs[inside]
    for du, dv in _DOT:
        u, v = us + du, vs + dv
        keep = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        img[v[keep], u[keep]] = color
    return img


def _jet_lut() -> np.ndarray:
    """(256, 3) uint8 BGR: blue (0.5) -> blue -> cyan -> yellow -> red -> red (0.5)."""
    x = np.arange(256) / 255.0
    ramp = lambda c: np.clip(1.5 - np.abs(4.0 * x - c), 0.0, 1.0)  # noqa: E731
    return np.round(np.stack([ramp(1.0), ramp(2.0), ramp(3.0)], axis=1) * 255).astype(np.uint8)


_JET = _jet_lut()


def heatmap(data: np.ndarray, to_rgb: bool = False) -> np.ndarray:
    """A scalar map normalized to [0, 1] and coloured JET: (H, W, 3) uint8,
    BGR as OpenCV gives it, or RGB."""
    d = np.asarray(data, dtype=np.float32)
    d = d - d.min()
    if d.max() > 0:
        d = d / d.max()
    img = _JET[(d * 255).astype(np.uint8)]
    return img[:, :, ::-1].copy() if to_rgb else img


def grid_show(images, titles=None, row: int = 1, col: int = 1, save_path: str | None = None,
              gap: int = 4) -> np.ndarray:
    """Tile up to row x col RGB (or greyscale) panels, left to right and top
    to bottom, on a white canvas with `gap` pixels between them; with
    `save_path` write it as a PNG. `titles` are accepted and not drawn.
    -> the tiled RGB image."""
    panels = [np.repeat(np.asarray(im)[:, :, None], 3, axis=2) if np.asarray(im).ndim == 2
              else np.asarray(im) for im in images[:row * col]]
    ph = max(p.shape[0] for p in panels)
    pw = max(p.shape[1] for p in panels)
    canvas = np.full((row * ph + (row - 1) * gap, col * pw + (col - 1) * gap, 3), 255, np.uint8)
    for i, p in enumerate(panels):
        r, c = divmod(i, col)
        y, x = r * (ph + gap), c * (pw + gap)
        canvas[y:y + p.shape[0], x:x + p.shape[1]] = p.astype(np.uint8)
    if save_path:
        png.write_png(save_path, np.ascontiguousarray(canvas[:, :, ::-1]))   # writer takes BGR
    return canvas
