"""The OpenCV calls of the JAX package's colour augmentation, on numpy.

`catre_tpu/data/aug_color.py` calls OpenCV on uint8 HWC images; the GPU host
has no OpenCV. Each function here gives what the OpenCV 8-bit call gives, bit
for bit on the inputs the tests sweep (OpenCV 5.0 with its AVX2 code paths):

- `gaussian_blur` = `GaussianBlur(img, (0, 0), sigma)`: OpenCV's bit-exact
  8-bit kernel (size round(6 sigma + 1) | 1, 8 fraction bits by error
  diffusion) in two fixed-point passes;
- `box_blur` = `blur(img, (k, k))`: box sums rounded half up (at k = 4 by a
  16-bit reciprocal);
- `median_blur` = `medianBlur(img, k)`, its border replicated;
- `filter2d` = `filter2D(img, -1, kernel)` with a float32 kernel: float32
  sums by fused multiply-adds in the kernel's row-major order, rounded half to
  even;
- `draw_line` = `line(img, p1, p2, color, thickness=1)`, 8-connected;
- `resize_linear` = `resize(img, (w, h))` INTER_LINEAR: 11-bit weights, the
  vertical pass in 16-bit products, as the vector code computes it;
- `rgb_to_hsv` / `hsv_to_rgb` = `cvtColor` RGB <-> HSV, H in 0-180;
- `rgb_to_lab` / `lab_to_rgb` = `cvtColor` RGB <-> Lab, OpenCV's integer
  tables;
- `clahe` = `createCLAHE(clip, (8, 8)).apply(img)`.

Borders are OpenCV's default, BORDER_REFLECT_101, except for the median.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Indices of 0..n-1 extended by `lo` / `hi` under BORDER_REFLECT_101."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _pad(img: np.ndarray, top: int, bottom: int, left: int, right: int) -> np.ndarray:
    return img[reflect101(img.shape[0], top, bottom)][:, reflect101(img.shape[1], left, right)]


def _fma32(acc: np.ndarray, x: np.ndarray, c) -> np.ndarray:
    """float32 acc + x * c with one rounding (the product of a float32 and an
    8-bit value is exact in float64)."""
    return (acc.astype(np.float64) + x.astype(np.float64) * float(c)).astype(_F32)


def _round_u8(x: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar> of a float: round half to even, then clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# ---- blurs and filters

def gaussian_kernel_q8(sigma: float) -> np.ndarray:
    """OpenCV's bit-exact 8-bit Gaussian kernel for `sigma`: the sampled
    kernel normalised in float64, then taken to 8 fraction bits by error
    diffusion from the ends, the centre holding what is left of 256."""
    n = int(np.rint(sigma * 6 + 1)) | 1
    if n == 1:
        return np.array([256], np.int64)
    scale2x = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    vals = [math.exp(float(x * x) * scale2x) for x in range(1 - n, 0, 2)]
    total = 2.0 * sum(vals) + 1.0
    mul = 1.0 / total
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(half):
        adj = vals[i] * mul * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
    out[half] = 256 - 2 * int(out[:half].sum())
    return out


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigma)` on uint8: horizontal sums in
    units of 2^-8, vertical in 2^-16, rounded half up."""
    k = gaussian_kernel_q8(sigma)
    n = k.size
    p = n // 2
    h, w = img.shape[:2]
    x = img.astype(np.int64)[:, reflect101(w, p, p)]
    rows = sum(int(k[j]) * x[:, j:j + w] for j in range(n))
    rows = rows[reflect101(h, p, p)]
    out = sum(int(k[j]) * rows[j:j + h] for j in range(n))
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _box_sums(img: np.ndarray, k: int) -> np.ndarray:
    """k x k window sums, anchor k // 2, reflect-101 border."""
    h, w = img.shape[:2]
    a = k // 2
    x = _pad(img.astype(np.int64), a, k - 1 - a, a, k - 1 - a)
    rows = sum(x[:, j:j + w] for j in range(k))
    return sum(rows[j:j + h] for j in range(k))


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.blur(img, (k, k))` on uint8: the window sum over k^2 rounded half
    up, but for k = 4, where OpenCV multiplies by a 16-bit reciprocal with a
    rounding correction (ColumnSum<ushort, uchar>). Measured for k = 3..7,
    the sizes the albumentations Blur draws."""
    s = _box_sums(img, k)
    d = k * k
    if k != 4:
        return ((s + d // 2) // d).astype(np.uint8)
    scalef = 65536.0 / d
    div = math.floor(scalef)
    delta = d // 2
    if scalef - div < 0.5:
        delta += 1
    else:
        div += 1
    return (((s + delta) * div) >> 16).astype(np.uint8)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.medianBlur(img, k)` on uint8 (odd k), its border replicated."""
    h, w = img.shape[:2]
    p = k // 2
    x = img[np.clip(np.arange(-p, h + p), 0, h - 1)][:, np.clip(np.arange(-p, w + p), 0, w - 1)]
    win = np.stack([x[i:i + h, j:j + w] for i in range(k) for j in range(k)])
    return np.sort(win, axis=0)[k * k // 2]


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.filter2D(img, -1, kernel)` on uint8 with a float32 kernel
    (correlation, anchor at the centre)."""
    kernel = np.asarray(kernel, _F32)
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    x = _pad(img, ay, kh - 1 - ay, ax, kw - 1 - ax)
    acc = np.zeros(img.shape, _F32)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0:
                acc = _fma32(acc, x[i:i + h, j:j + w], kernel[i, j])
    return _round_u8(acc)


def draw_line(canvas: np.ndarray, p1: tuple, p2: tuple, value) -> None:
    """`cv2.line(canvas, p1, p2, value, thickness=1)`: OpenCV's 8-connected
    LineIterator, drawn left to right, in place. Points are (x, y) inside
    the canvas."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    sx = sy = 1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        sx, sy = sy, sx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        canvas[y, x] = value
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sx
            x += sy if step else 0
        else:
            x += sx
            y += sy if step else 0


# ---- resize

def _linear_taps(dst: int, src: int, clamp: bool) -> tuple:
    """Source rows / columns and 11-bit weights of INTER_LINEAR. Columns
    outside the source take the edge with weight 1; rows are clamped but
    keep their fractional weights, as OpenCV computes them."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        hi = s >= src - 1
        f[hi] = 0
        s[hi] = src - 1
    w1 = np.rint(f * _F32(2048)).astype(np.int64)
    w0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height))` (INTER_LINEAR) on uint8 HWC."""
    sh, sw = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(width, sw, clamp=True)
    y0, y1, b0, b1 = _linear_taps(height, sh, clamp=False)
    x = img.astype(np.int64)
    row = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    s0, s1 = row[y0] >> 4, row[y1] >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


# ---- colour spaces

def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2HSV)` on uint8 (H in 0-180)."""
    shift = 12
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << shift) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << shift) / (6.0 * i))]).astype(np.int64)
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + (1 << (shift - 1))) >> shift
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << (shift - 1))) >> shift
    h += np.where(h < 0, 180, 0)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_HSV_LANES = 32          # pixels a vector step of OpenCV's AVX2 HSV -> RGB


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)` on uint8 (H in 0-180): float32
    with fused multiply-adds, truncated to 8 bits in the vector steps of 32
    pixels a row and rounded in the rest of the row."""
    h = hsv[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = hsv[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = hsv[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.trunc(h)
    h = h - sector
    sector = (sector - np.trunc(sector * _F32(1.0 / 6.0)) * _F32(6)).astype(np.int64)
    one = _F32(1)

    def one_minus(a, b):            # 1 - a * b with one rounding (a fused multiply-add)
        return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(_F32)

    tab = np.stack([v, v * (one - s), v * one_minus(s, h), v * one_minus(s, one - h)], axis=-1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[np.clip(sector, 0, 5)], axis=-1) * _F32(255)
    out = np.trunc(bgr)
    w = hsv.shape[1]
    tail = w - w % _HSV_LANES
    out[:, tail:] = np.rint(bgr[:, tail:])
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def _cv_round(x) -> int:
    return int(np.rint(x))


# sRGB and the D65 white point of OpenCV's colour tables
_GAMMA_THRESHOLD, _GAMMA_INV_THRESHOLD = 809 / 20000, 7827 / 2500000
_GAMMA_LOW_SCALE, _GAMMA_POWER, _GAMMA_X_SHIFT = 323 / 25, 12 / 5, 11 / 200
_RGB2XYZ = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
            0.019334, 0.119193, 0.950227)
_XYZ2RGB = (3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
            0.055648, -0.204043, 1.057311)
_D65 = (0.950456, 1.0, 1.088754)
_LAB_BASE = 1 << 14
_MIN_AB = -8145
# OpenCV's own float cube root gives the float below the nearest one at
# x = 324 / 2040, and so one less in this entry (cv2's RGB -> Lab over all
# 2^24 colours shows it; every other entry is the nearest cube root)
_CBRT_ENTRY_FIX = {324: 17745}


def _gamma(x32) -> _F32:
    x = float(x32)
    return _F32(x / _GAMMA_LOW_SCALE if x <= _GAMMA_THRESHOLD else
                ((x + _GAMMA_X_SHIFT) / (1.0 + _GAMMA_X_SHIFT)) ** _GAMMA_POWER)


def _inv_gamma(x32) -> _F32:
    x = float(x32)
    return _F32(x * _GAMMA_LOW_SCALE if x <= _GAMMA_INV_THRESHOLD else
                (x ** (1.0 / _GAMMA_POWER)) * (1.0 + _GAMMA_X_SHIFT) - _GAMMA_X_SHIFT)


def _lab_tables() -> dict:
    """The integer tables of OpenCV's 8-bit RGB <-> Lab (initLabTabs)."""
    lthresh = _F32(216) / _F32(24389)
    lscale = _F32(841) / _F32(108)
    lbias = _F32(16) / _F32(116)
    gamma = np.array([_cv_round(_F32(2040) * _gamma(_F32(i) / _F32(255))) for i in range(256)])
    inv_scale = _F32(1) / _F32(4096)
    inv_gamma = np.array([_cv_round(_F32(255) * _inv_gamma(inv_scale * _F32(i)))
                          for i in range(4096)])
    cb_scale = _F32(1) / (_F32(255) * _F32(8))
    cbrt = []
    for i in range(3072):
        x = cb_scale * _F32(i)
        f = (_F32(float(x) * float(lscale) + float(lbias)) if x < lthresh
             else _F32(np.cbrt(np.float64(x))))
        cbrt.append(_cv_round(_F32(1 << 15) * f))
    for i, v in _CBRT_ENTRY_FIX.items():
        cbrt[i] = v
    to_xyz = np.array([[_cv_round(4096.0 * _RGB2XYZ[3 * i + j] / _D65[i]) for j in range(3)]
                       for i in range(3)], np.int64)
    to_rgb = np.array([[_cv_round(4096.0 * _XYZ2RGB[3 * i + j] * _D65[j]) for j in range(3)]
                       for i in range(3)], np.int64)
    base = _LAB_BASE
    ab = np.arange(_MIN_AB, base * 9 // 4 + _MIN_AB, dtype=np.int64)
    lin = np.abs(ab * 108) // 841 * np.sign(ab)          # C's truncating division
    ab_to_xz = np.where(ab <= 3390, lin - (base * 16 // 116 * 108 // 841),
                        (ab * ab // base) * ab // base)
    l_y = np.zeros(256, np.int64)
    l_ify = np.zeros(256, np.int64)
    for i in range(256):
        if i <= 20:
            l_y[i] = _cv_round(_F32(i * base * 20 * 9) / _F32(17 * 29 * 29 * 29))
            l_ify[i] = _cv_round(_F32(base) * (_F32(16) / _F32(116)
                                                + _F32(i * 5) / _F32(3 * 17 * 29)))
        else:
            fy = _F32(i * 100 * base) / _F32(255 * 116) + _F32(16 * base) / _F32(116)
            l_ify[i] = _cv_round(fy)
            l_y[i] = _cv_round(fy * fy * fy / _F32(base * base))
    return {"gamma": gamma, "inv_gamma": inv_gamma, "cbrt": np.array(cbrt, np.int64),
            "to_xyz": to_xyz, "to_rgb": to_rgb, "ab_to_xz": ab_to_xz, "l_y": l_y, "l_ify": l_ify}


_LAB = None


def _lab() -> dict:
    global _LAB
    if _LAB is None:
        _LAB = _lab_tables()
    return _LAB


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def rgb_to_lab(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2LAB)` on uint8."""
    t = _lab()
    rgb = [t["gamma"][img[..., c]] for c in range(3)]
    f = [t["cbrt"][_descale(sum(rgb[j] * t["to_xyz"][i, j] for j in range(3)), 12)]
         for i in range(3)]
    lshift = -((16 * 255 * (1 << 15) + 50) // 100)
    L = _descale(((116 * 255 + 50) // 100) * f[1] + lshift, 15)
    a = _descale(500 * (f[0] - f[1]) + (128 << 15), 15)
    b = _descale(200 * (f[1] - f[2]) + (128 << 15), 15)
    return np.clip(np.stack([L, a, b], axis=-1), 0, 255).astype(np.uint8)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)` on uint8."""
    t = _lab()
    L, A, B = (lab[..., c].astype(np.int64) for c in range(3))
    y, ify = t["l_y"][L], t["l_ify"][L]
    adiv = ((5 * A * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    bdiv = ((B * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    x = t["ab_to_xz"][ify + adiv - _MIN_AB]
    z = t["ab_to_xz"][ify - bdiv - _MIN_AB]
    out = [t["inv_gamma"][np.clip(_descale(t["to_rgb"][i, 0] * x + t["to_rgb"][i, 1] * y
                                           + t["to_rgb"][i, 2] * z, 14), 0, 4095)]
           for i in range(3)]
    return np.clip(np.stack(out, axis=-1), 0, 255).astype(np.uint8)


def clahe(img: np.ndarray, clip_limit: float, tiles: tuple = (8, 8)) -> np.ndarray:
    """`cv2.createCLAHE(clip_limit, tiles).apply(img)` on a uint8 plane."""
    tx, ty = tiles
    h, w = img.shape
    ext = img
    if w % tx or h % ty:
        ext = _pad(img, 0, ty - h % ty, 0, tx - w % tx)
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    lut_scale = _F32(255) / _F32(area)
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    tiles_ = ext[:ty * th, :tx * tw].reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(ty * tx, -1)
    hist = np.stack([np.bincount(t, minlength=256) for t in tiles_]).astype(np.int64)
    if limit > 0:
        clipped = np.maximum(hist - limit, 0).sum(axis=1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        residual = clipped % 256
        for i, r in enumerate(residual.tolist()):
            if r:
                hist[i, np.arange(0, 256, max(256 // r, 1))[:r]] += 1
    luts = np.clip(np.rint(np.cumsum(hist, axis=1).astype(_F32) * lut_scale), 0, 255)
    luts = luts.astype(np.int64).reshape(ty, tx, 256)

    def axis(n, size, count):
        f = np.arange(n, dtype=_F32) * (_F32(1) / _F32(size)) - _F32(0.5)
        i1 = np.floor(f).astype(np.int64)
        frac = (f - i1.astype(_F32)).astype(_F32)
        return np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), frac, _F32(1) - frac

    x1, x2, xa, xa1 = axis(w, tw, tx)
    y1, y2, ya, ya1 = axis(h, th, ty)
    v = img.astype(np.int64)
    p11, p12 = luts[y1[:, None], x1[None, :], v], luts[y1[:, None], x2[None, :], v]
    p21, p22 = luts[y2[:, None], x1[None, :], v], luts[y2[:, None], x2[None, :], v]
    res = ((p11.astype(_F32) * xa1 + p12.astype(_F32) * xa) * ya1[:, None]
           + (p21.astype(_F32) * xa1 + p22.astype(_F32) * xa) * ya[:, None])
    return _round_u8(res)
