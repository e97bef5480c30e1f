"""Image-space colour augmentation and background replacement.

Counterpart of `catre_tpu/data/aug_color.py`, with its names and its order of
draws: the combinators (:31-61), the imgaug-style ops (:64-150), `_aae_chain`
(:153), `AugmentRGB` (:165), the albumentations-style ops and namespace
(:213-571), `build_color_augmentor` (:574), `color_augment` (:606),
`build_bg_paths` / `_bg_paths_cached` (:620-696), `trunc_mask` (:699),
`_fit_bg` (:723) and `replace_background` (:739).

Every op takes (rng, uint8 RGB image) and returns uint8; randomness comes
from the caller's positional generator. The ops that the JAX package
computes in numpy are copied; its OpenCV calls are `imgproc.py`'s, its JPEG
round trip `jpeg.jpeg_round_trip`, and backgrounds are read by `read_image`
(JPEG through `jpeg.py`, PNG through `png.py`, uncompressed BMP here), which
returns OpenCV's IMREAD_COLOR array or None for a missing file. A file that
OpenCV could read but these readers cannot raises and names its format: no
path returns the image unchanged for want of a decoder.
"""

from __future__ import annotations

import os

import numpy as np

from . import imgproc, jpeg, png


# ------------------------------------------------------------- imgaug-style
class Sequential:
    """Apply ops in order (`random_order` permutes them with one draw)."""

    def __init__(self, ops, random_order: bool = False):
        self.ops = list(ops)
        self.random_order = random_order

    def __call__(self, rng, img):
        ops = self.ops
        if self.random_order:
            ops = [self.ops[i] for i in rng.permutation(len(self.ops))]
        for op in ops:
            img = op(rng, img)
        return img


class Sometimes:
    def __init__(self, p, op):
        self.p, self.op = float(p), op

    def __call__(self, rng, img):
        return self.op(rng, img) if rng.random() < self.p else img


class OneOf:
    def __init__(self, ops):
        self.ops = list(ops)

    def __call__(self, rng, img):
        return self.ops[int(rng.integers(len(self.ops)))](rng, img)


def _per_channel(rng, prob) -> bool:
    return rng.random() < float(prob)


class CoarseDropout:
    """Zero coarse rectangles: a low-resolution bernoulli(p) mask at
    `size_percent` scale, upsampled nearest (imgaug CoarseDropout)."""

    def __init__(self, p=0.1, size_percent=0.05):
        self.p, self.size_percent = float(p), float(size_percent)

    def __call__(self, rng, img):
        h, w = img.shape[:2]
        lh = max(1, int(round(h * self.size_percent)))
        lw = max(1, int(round(w * self.size_percent)))
        drop = rng.random((lh, lw)) < self.p
        mask = np.repeat(np.repeat(drop, -(-h // lh), axis=0)[:h], -(-w // lw), axis=1)[:, :w]
        out = img.copy()
        out[mask] = 0
        return out


class GaussianBlur:
    def __init__(self, sigma=1.0):
        self.sigma = float(sigma)

    def __call__(self, rng, img):
        if self.sigma <= 0:
            return img
        return imgproc.gaussian_blur(img, self.sigma)


class Add:
    def __init__(self, value=(-20, 20), per_channel=0.0):
        self.lo, self.hi = value
        self.per_channel = per_channel

    def __call__(self, rng, img):
        shape = (1, 1, 3) if _per_channel(rng, self.per_channel) else (1, 1, 1)
        delta = rng.integers(self.lo, self.hi + 1, size=shape)
        return np.clip(img.astype(np.int32) + delta, 0, 255).astype(np.uint8)


class Invert:
    def __init__(self, p=0.2, per_channel=False):
        self.p, self.per_channel = float(p), bool(per_channel)

    def __call__(self, rng, img):
        out = img.copy()
        if self.per_channel:
            for c in range(img.shape[-1]):
                if rng.random() < self.p:
                    out[:, :, c] = 255 - out[:, :, c]
        elif rng.random() < self.p:
            out = 255 - out
        return out


class Multiply:
    def __init__(self, mul=(0.8, 1.2), per_channel=0.0):
        self.lo, self.hi = mul
        self.per_channel = per_channel

    def __call__(self, rng, img):
        shape = (1, 1, 3) if _per_channel(rng, self.per_channel) else (1, 1, 1)
        m = rng.uniform(self.lo, self.hi, size=shape).astype(np.float32)
        return np.clip(img.astype(np.float32) * m, 0, 255).astype(np.uint8)


class LinearContrast:
    """x' = 127 + alpha (x - 127) (imgaug LinearContrast)."""

    def __init__(self, alpha=(0.6, 1.4), per_channel=0.0):
        self.lo, self.hi = alpha
        self.per_channel = per_channel

    def __call__(self, rng, img):
        shape = (1, 1, 3) if _per_channel(rng, self.per_channel) else (1, 1, 1)
        a = rng.uniform(self.lo, self.hi, size=shape).astype(np.float32)
        return np.clip(127.0 + a * (img.astype(np.float32) - 127.0), 0, 255).astype(np.uint8)


def _aae_chain(rng_build: np.random.Generator) -> Sequential:
    """The reference's shipped AAE chain; the blur's sigma is drawn once,
    when the chain is built."""
    return Sequential([
        Sometimes(0.5, CoarseDropout(p=0.2, size_percent=0.05)),
        Sometimes(0.5, GaussianBlur(1.2 * rng_build.random())),
        Sometimes(0.5, Add((-25, 25), per_channel=0.3)),
        Sometimes(0.3, Invert(0.2, per_channel=True)),
        Sometimes(0.5, Multiply((0.6, 1.4), per_channel=0.5)),
        Sometimes(0.5, Multiply((0.6, 1.4))),
        Sometimes(0.5, LinearContrast((0.5, 2.2), per_channel=0.3)),
    ], random_order=False)


class AugmentRGB:
    """roi10d family: shuffled brightness / saturation / contrast jitter on
    [0, 1] floats."""

    def __init__(self, brightness_delta=32.0 / 255.0, lighting_std=0.3,
                 saturation_var=(0.75, 1.25), contrast_var=(0.75, 1.25)):
        self.brightness_delta = brightness_delta
        self.lighting_std = lighting_std
        self.saturation_var = saturation_var
        self.contrast_var = contrast_var

    def __call__(self, rng, img):
        x = img.astype(np.float32) / 255.0
        jitters = [self._brightness, self._saturation, self._contrast]
        for j in rng.permutation(len(jitters)):
            x = jitters[int(j)](rng, x)
        return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    def _brightness(self, rng, x):
        d = self.brightness_delta
        return np.clip(x + (-d + 2 * rng.random() * d), 0.0, 1.0)

    def _saturation(self, rng, x):
        lo, hi = self.saturation_var
        f = lo + 2 * rng.random() * (hi - lo)
        gray = (x * np.array([0.299, 0.587, 0.114], np.float32)).sum(-1, keepdims=True)
        return np.clip(f * x + (1 - f) * gray, 0.0, 1.0)

    def _contrast(self, rng, x):
        lo, hi = self.contrast_var
        f = lo + 2 * rng.random() * (hi - lo)
        m = x.mean(axis=(0, 1))
        return np.clip((x - m) * f + m, 0.0, 1.0)


# --------------------------------------------------------------- albu-style
# COLOR_AUG_TYPE="code_albu" chain strings are evaluated against this
# namespace. Every transform carries its own probability `p`; Compose gates a
# sequential chain; OneOf picks one child weighted by the children's p and
# forces it. The geometric transforms raise when constructed.

def _ksize(rng, blur_limit, odd=True):
    lo = 3
    hi = max(int(blur_limit), lo)
    k = int(rng.integers(lo, hi + 1))
    if odd and k % 2 == 0:
        k += 1
    return k


class _AlbuTransform:
    def __init__(self, p=0.5):
        self.p = float(p)

    def __call__(self, rng, img, force=False):
        if force or rng.random() < self.p:
            return self.apply(rng, img)
        return img

    def apply(self, rng, img):  # pragma: no cover - abstract
        raise NotImplementedError


class AlbuCompose(_AlbuTransform):
    """albumentations.Compose: with prob p, apply the children in order."""

    def __init__(self, transforms, p=1.0):
        super().__init__(p)
        self.transforms = list(transforms)

    def apply(self, rng, img):
        for t in self.transforms:
            img = t(rng, img)
        return img


class AlbuOneOf(_AlbuTransform):
    """albumentations.OneOf: with prob p, one child, weighted by the
    children's p, applied unconditionally."""

    def __init__(self, transforms, p=0.5):
        super().__init__(p)
        self.transforms = list(transforms)
        ps = np.asarray([t.p for t in self.transforms], np.float64)
        self._weights = ps / ps.sum() if ps.sum() > 0 else None

    def apply(self, rng, img):
        if not self.transforms:
            return img
        i = int(rng.choice(len(self.transforms), p=self._weights))
        return self.transforms[i](rng, img, force=True)


class AlbuCoarseDropout(_AlbuTransform):
    """n = randint(min_holes..max_holes) rectangles of randint(min_h..max_h)
    x randint(min_w..max_w) filled with fill_value (min_* default to max_*)."""

    def __init__(self, max_holes=8, max_height=8, max_width=8, min_holes=None,
                 min_height=None, min_width=None, fill_value=0, p=0.5):
        super().__init__(p)
        self.max_holes = int(max_holes)
        self.max_height = int(max_height)
        self.max_width = int(max_width)
        self.min_holes = int(min_holes) if min_holes is not None else self.max_holes
        self.min_height = int(min_height) if min_height is not None else self.max_height
        self.min_width = int(min_width) if min_width is not None else self.max_width
        self.fill_value = fill_value

    def apply(self, rng, img):
        h, w = img.shape[:2]
        out = img.copy()
        n = int(rng.integers(self.min_holes, self.max_holes + 1))
        for _ in range(n):
            hh = int(rng.integers(self.min_height, self.max_height + 1))
            hw = int(rng.integers(self.min_width, self.max_width + 1))
            y = int(rng.integers(0, max(h - hh, 0) + 1))
            x = int(rng.integers(0, max(w - hw, 0) + 1))
            out[y:y + hh, x:x + hw] = self.fill_value
        return out


class AlbuGaussNoise(_AlbuTransform):
    def __init__(self, var_limit=(10.0, 50.0), p=0.5):
        super().__init__(p)
        self.var_limit = var_limit

    def apply(self, rng, img):
        var = rng.uniform(*self.var_limit)
        noise = rng.normal(0.0, var ** 0.5, size=img.shape)
        return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


class AlbuIAAAdditiveGaussianNoise(_AlbuTransform):
    """imgaug AdditiveGaussianNoise: a per-image sigma uniform in `scale`."""

    def __init__(self, loc=0, scale=(0.01 * 255, 0.05 * 255), p=0.5):
        super().__init__(p)
        self.loc, self.scale = loc, scale

    def apply(self, rng, img):
        sigma = rng.uniform(*self.scale)
        noise = rng.normal(self.loc, sigma, size=img.shape)
        return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


class AlbuBlur(_AlbuTransform):
    def __init__(self, blur_limit=7, p=0.5):
        super().__init__(p)
        self.blur_limit = blur_limit

    def apply(self, rng, img):
        return imgproc.box_blur(img, _ksize(rng, self.blur_limit, odd=False))


class AlbuMedianBlur(_AlbuTransform):
    def __init__(self, blur_limit=7, p=0.5):
        super().__init__(p)
        self.blur_limit = blur_limit

    def apply(self, rng, img):
        return imgproc.median_blur(img, _ksize(rng, self.blur_limit))


class AlbuMotionBlur(_AlbuTransform):
    """A random-direction line kernel of odd size in [3, blur_limit]."""

    def __init__(self, blur_limit=7, p=0.5):
        super().__init__(p)
        self.blur_limit = blur_limit

    def apply(self, rng, img):
        k = _ksize(rng, self.blur_limit)
        kernel = np.zeros((k, k), np.float32)
        x1, y1 = int(rng.integers(k)), int(rng.integers(k))
        x2, y2 = int(rng.integers(k)), int(rng.integers(k))
        imgproc.draw_line(kernel, (x1, y1), (x2, y2), 1.0)
        s = kernel.sum()
        if s == 0:
            kernel[k // 2, k // 2] = 1.0
            s = 1.0
        return imgproc.filter2d(img, kernel / s)


class AlbuCLAHE(_AlbuTransform):
    """The clip drawn uniform in (1, clip_limit); applied to Lab's L."""

    def __init__(self, clip_limit=4.0, tile_grid_size=(8, 8), p=0.5):
        super().__init__(p)
        self.clip_limit = clip_limit
        self.tile_grid_size = tuple(tile_grid_size)

    def apply(self, rng, img):
        clip = rng.uniform(1.0, float(self.clip_limit))
        lab = imgproc.rgb_to_lab(img)
        lab[:, :, 0] = imgproc.clahe(lab[:, :, 0], clip, self.tile_grid_size)
        return imgproc.lab_to_rgb(lab)


class AlbuIAASharpen(_AlbuTransform):
    """imgaug Sharpen: img blended with a sharpening response,
    alpha ~ U(0.2, 0.5), lightness ~ U(0.5, 1.0)."""

    def __init__(self, alpha=(0.2, 0.5), lightness=(0.5, 1.0), p=0.5):
        super().__init__(p)
        self.alpha, self.lightness = alpha, lightness

    def apply(self, rng, img):
        a = rng.uniform(*self.alpha)
        li = rng.uniform(*self.lightness)
        kernel = np.array([[-1, -1, -1], [-1, 8 + li, -1], [-1, -1, -1]], np.float32)
        sharp = imgproc.filter2d(img, kernel)
        return np.clip((1 - a) * img.astype(np.float32)
                       + a * sharp.astype(np.float32), 0, 255).astype(np.uint8)


class AlbuIAAEmboss(_AlbuTransform):
    def __init__(self, alpha=(0.2, 0.5), strength=(0.2, 0.7), p=0.5):
        super().__init__(p)
        self.alpha, self.strength = alpha, strength

    def apply(self, rng, img):
        a = rng.uniform(*self.alpha)
        s = rng.uniform(*self.strength)
        kernel = np.array([[-1 - s, -s, 0], [-s, 1, s], [0, s, 1 + s]], np.float32)
        emb = imgproc.filter2d(img, kernel)
        return np.clip((1 - a) * img.astype(np.float32)
                       + a * emb.astype(np.float32), 0, 255).astype(np.uint8)


class AlbuRandomBrightnessContrast(_AlbuTransform):
    """alpha = 1 + U(-contrast, contrast), beta = U(-brightness, brightness):
    img * alpha + beta * 255."""

    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=0.5):
        super().__init__(p)
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit

    def apply(self, rng, img):
        alpha = 1.0 + rng.uniform(-self.contrast_limit, self.contrast_limit)
        beta = rng.uniform(-self.brightness_limit, self.brightness_limit)
        return np.clip(img.astype(np.float32) * alpha + beta * 255.0, 0, 255).astype(np.uint8)


class AlbuRandomContrast(AlbuRandomBrightnessContrast):
    def __init__(self, limit=0.2, p=0.5):
        super().__init__(brightness_limit=0.0, contrast_limit=limit, p=p)


class AlbuRandomBrightness(AlbuRandomBrightnessContrast):
    def __init__(self, limit=0.2, p=0.5):
        super().__init__(brightness_limit=limit, contrast_limit=0.0, p=p)


class AlbuInvertImg(_AlbuTransform):
    def apply(self, rng, img):
        return 255 - img


class AlbuRGBShift(_AlbuTransform):
    def __init__(self, r_shift_limit=20, g_shift_limit=20, b_shift_limit=20, p=0.5):
        super().__init__(p)
        self.limits = (r_shift_limit, g_shift_limit, b_shift_limit)

    def apply(self, rng, img):
        shift = np.array([rng.uniform(-lim, lim) for lim in self.limits], np.float32)
        return np.clip(img.astype(np.float32) + shift, 0, 255).astype(np.uint8)


class AlbuRandomGamma(_AlbuTransform):
    def __init__(self, gamma_limit=(80, 120), p=0.5):
        super().__init__(p)
        self.gamma_limit = gamma_limit

    def apply(self, rng, img):
        gamma = rng.uniform(*self.gamma_limit) / 100.0
        lut = np.clip(((np.arange(256) / 255.0) ** gamma) * 255.0, 0, 255).astype(np.uint8)
        return lut[img]


class AlbuHueSaturationValue(_AlbuTransform):
    def __init__(self, hue_shift_limit=20, sat_shift_limit=30, val_shift_limit=20, p=0.5):
        super().__init__(p)
        self.limits = (hue_shift_limit, sat_shift_limit, val_shift_limit)

    def apply(self, rng, img):
        hs = rng.uniform(-self.limits[0], self.limits[0])
        ss = rng.uniform(-self.limits[1], self.limits[1])
        vs = rng.uniform(-self.limits[2], self.limits[2])
        hsv = imgproc.rgb_to_hsv(img).astype(np.float32)
        hsv[:, :, 0] = np.mod(hsv[:, :, 0] + hs, 180.0)
        hsv[:, :, 1] = np.clip(hsv[:, :, 1] + ss, 0, 255)
        hsv[:, :, 2] = np.clip(hsv[:, :, 2] + vs, 0, 255)
        return imgproc.hsv_to_rgb(hsv.astype(np.uint8))


class AlbuJpegCompression(_AlbuTransform):
    def __init__(self, quality_lower=99, quality_upper=100, p=0.5):
        super().__init__(p)
        self.quality_lower, self.quality_upper = quality_lower, quality_upper

    def apply(self, rng, img):
        q = int(rng.integers(int(self.quality_lower), int(self.quality_upper) + 1))
        return jpeg.jpeg_round_trip(img, q)


class AlbuHorizontalFlip(_AlbuTransform):
    def apply(self, rng, img):
        return np.ascontiguousarray(img[:, ::-1])


class AlbuFlip(_AlbuTransform):
    """A random flip direction in {-1, 0, 1} (cv2.flip codes)."""

    def apply(self, rng, img):
        d = int(rng.integers(-1, 2))
        if d == -1:
            return np.ascontiguousarray(img[::-1, ::-1])
        return np.ascontiguousarray(img[::-1] if d == 0 else img[:, ::-1])


class AlbuTranspose(_AlbuTransform):
    def apply(self, rng, img):
        return np.ascontiguousarray(img.transpose(1, 0, 2))


class AlbuRandomRotate90(_AlbuTransform):
    def apply(self, rng, img):
        return np.ascontiguousarray(np.rot90(img, int(rng.integers(4))))


def _albu_unsupported(name):
    class _Unsupported:
        def __init__(self, *a, **k):
            raise NotImplementedError(
                f"albumentations transform {name!r} (geometric warp) is not supported by "
                "the code_albu evaluator: it would break pixel alignment with the depth and "
                "mask channels the CATRE loader backprojects")

    _Unsupported.__name__ = name
    return _Unsupported


def _albu_namespace():
    ns = {
        "Compose": AlbuCompose, "OneOf": AlbuOneOf,
        "CoarseDropout": AlbuCoarseDropout,
        "GaussNoise": AlbuGaussNoise,
        "IAAAdditiveGaussianNoise": AlbuIAAAdditiveGaussianNoise,
        "Blur": AlbuBlur, "MedianBlur": AlbuMedianBlur,
        "MotionBlur": AlbuMotionBlur, "CLAHE": AlbuCLAHE,
        "IAASharpen": AlbuIAASharpen, "IAAEmboss": AlbuIAAEmboss,
        "RandomBrightnessContrast": AlbuRandomBrightnessContrast,
        "RandomContrast": AlbuRandomContrast,
        "RandomBrightness": AlbuRandomBrightness,
        "InvertImg": AlbuInvertImg, "RGBShift": AlbuRGBShift,
        "RandomGamma": AlbuRandomGamma,
        "HueSaturationValue": AlbuHueSaturationValue,
        "JpegCompression": AlbuJpegCompression,
        "HorizontalFlip": AlbuHorizontalFlip, "Flip": AlbuFlip,
        "Transpose": AlbuTranspose, "RandomRotate90": AlbuRandomRotate90,
        "np": np,
    }
    for name in ("IAAPerspective", "ShiftScaleRotate", "OpticalDistortion",
                 "GridDistortion", "IAAPiecewiseAffine"):
        ns[name] = _albu_unsupported(name)
    return ns


def build_color_augmentor(aug_type: str = "aae", aug_code: str = "", seed: int = 0):
    """The COLOR_AUG_TYPE selector: a callable (rng, uint8 RGB) -> uint8 RGB.
    "code" and "code_albu" evaluate COLOR_AUG_CODE against the ops above,
    with no builtins."""
    t = (aug_type or "").lower()
    rng_build = np.random.default_rng(seed)
    if t == "roi10d":
        return AugmentRGB(brightness_delta=2.5 / 255.0, lighting_std=0.3,
                          saturation_var=(0.95, 1.05), contrast_var=(0.95, 1.05))
    if t == "aae":
        return _aae_chain(rng_build)
    if t == "code":
        namespace = {
            "Sequential": Sequential, "Sometimes": Sometimes, "OneOf": OneOf,
            "CoarseDropout": CoarseDropout, "GaussianBlur": GaussianBlur,
            "Add": Add, "Invert": Invert, "Multiply": Multiply,
            "LinearContrast": LinearContrast, "np": np,
        }
        return eval(aug_code, {"__builtins__": {}}, namespace)  # noqa: S307
    if t == "code_albu":
        if not aug_code:
            raise ValueError("COLOR_AUG_TYPE='code_albu' requires INPUT.COLOR_AUG_CODE")
        return eval(aug_code, {"__builtins__": {}}, _albu_namespace())  # noqa: S307
    raise ValueError(f"COLOR_AUG_TYPE {aug_type!r} is not supported")


def color_augment(rng: np.random.Generator, img: np.ndarray, augmentor=None) -> np.ndarray:
    """Apply a colour augmentor (default: the AAE chain) to an RGB image.
    Takes uint8 or float; returns the same dtype."""
    if augmentor is None:
        augmentor = _aae_chain(rng)
    dtype = img.dtype
    if dtype == np.uint8:
        return augmentor(rng, img)
    scale = 255.0 if img.max() > 1.5 else 1.0
    u8 = np.clip(img * (255.0 / scale), 0, 255).astype(np.uint8)
    return augmentor(rng, u8).astype(np.float32) * (scale / 255.0)


# ------------------------------------------------------------- backgrounds

def decode_bmp(data: bytes, path="<bytes>") -> np.ndarray:
    """An uncompressed 24-bit BMP (BI_RGB, bottom-up or top-down) ->
    (H, W, 3) uint8 BGR. Other BMPs raise and name their format."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError(f"{path}: not a BMP file")
    offset = int.from_bytes(data[10:14], "little")
    header = int.from_bytes(data[14:18], "little")
    if header < 40:
        raise ValueError(f"{path}: OS/2 BMP (a {header}-byte header) is not read")
    w = int.from_bytes(data[18:22], "little", signed=True)
    h = int.from_bytes(data[22:26], "little", signed=True)
    bpp = int.from_bytes(data[28:30], "little")
    comp = int.from_bytes(data[30:34], "little")
    if comp != 0:
        raise ValueError(f"{path}: compressed BMP (compression {comp}) is not read")
    if bpp != 24:
        raise ValueError(f"{path}: {bpp}-bit BMP is not read (24-bit only)")
    stride = (3 * w + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, count=stride * abs(h), offset=offset)
    img = rows.reshape(abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


def read_image(path) -> np.ndarray | None:
    """`cv2.imread(path, cv2.IMREAD_COLOR)`: (H, W, 3) uint8 BGR, None for a
    missing file. The format is told by the file's first bytes, as OpenCV
    does; one that is not read here raises and names it."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:2] == b"\xff\xd8":
        return jpeg.decode_jpeg(data, path)
    if data[:8] == png.SIGNATURE:
        img = png.decode_png(data, path)
    elif data[:2] == b"BM":
        return decode_bmp(data, path)
    else:
        raise ValueError(f"{path}: an image format other than JPEG, PNG and BMP is not read")
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img


def _list_bg_images(bg_dir: str) -> list:
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    try:
        return sorted(os.path.join(bg_dir, f) for f in os.listdir(bg_dir)
                      if f.lower().endswith(exts))
    except OSError:
        return []


def build_bg_paths(bg_type: str, bg_root: str, num_bg_imgs: int = 10000, seed: int = 0) -> list:
    """The INPUT.BG_TYPE pool, then num_bg_imgs paths drawn WITH replacement.
    Sources:

    - "coco":      a flat directory of .png / .jpg (e.g. coco/train2017)
    - "VOC_table": a VOCdevkit/VOC2012 root; the images flagged 1 in
                   ImageSets/Main/diningtable_trainval.txt
    - "VOC" / "SUN2012": <root>/JPEGImages/*.jpg
    - "" / "file_dir": any flat image directory

    "SUN_RGBD" (a background depth pool) raises."""
    if bg_type in ("", "file_dir"):
        img_paths = _list_bg_images(bg_root)
    elif bg_type == "coco":
        try:
            img_paths = sorted(os.path.join(bg_root, fn.name) for fn in os.scandir(bg_root)
                               if ".png" in fn.name or "jpg" in fn.name)
        except OSError:
            img_paths = []
    elif bg_type == "VOC_table":
        list_path = os.path.join(bg_root, "ImageSets/Main", "diningtable_trainval.txt")
        try:
            with open(list_path) as f:
                ids = [ln.strip("\r\n").split()[0] for ln in f
                       if ln.strip("\r\n").split()[1] == "1"]
        except OSError:
            ids = []
        img_paths = [os.path.join(bg_root, f"JPEGImages/{i}.jpg") for i in ids]
    elif bg_type in ("VOC", "SUN2012"):
        jdir = os.path.join(bg_root, "JPEGImages")
        try:
            img_paths = sorted(os.path.join(jdir, fn.name) for fn in os.scandir(jdir)
                               if ".jpg" in fn.name)
        except OSError:
            img_paths = []
    elif bg_type == "SUN_RGBD":
        raise NotImplementedError(
            "BG_TYPE='SUN_RGBD' is a background-DEPTH pool (WITH_BG_DEPTH): the CATRE path "
            "never replaces depth, so it is not carried")
    else:
        raise ValueError(f"BG_TYPE {bg_type!r} is not supported")
    if not img_paths:
        return []
    n = min(len(img_paths), int(num_bg_imgs))
    sel = np.random.default_rng(seed).choice(len(img_paths), size=n)
    return [img_paths[i] for i in sel]


# (bg_type, bg_root, num_bg_imgs, seed) -> paths
_BG_PATHS_CACHE: dict = {}


def _bg_paths_cached(bg_type, bg_root, num_bg_imgs, seed=0):
    key = (bg_type, bg_root, int(num_bg_imgs), int(seed))
    if key not in _BG_PATHS_CACHE:
        _BG_PATHS_CACHE[key] = build_bg_paths(bg_type, bg_root, num_bg_imgs, seed=seed)
    return _BG_PATHS_CACHE[key]


def trunc_mask(rng: np.random.Generator, mask: np.ndarray) -> np.ndarray:
    """TRUNCATE_FG: with probability 0.2 each, clear the rows above / below or
    the columns left / right of a point drawn uniformly between the fg bbox
    edge and its centre (else the mask is kept)."""
    mask = mask.copy().astype(bool)
    rows, cols = np.nonzero(mask)
    if rows.size == 0:
        return mask
    r1, r2 = rows.min(), rows.max()
    c1, c2 = cols.min(), cols.max()
    c_r, c_c = 0.5 * (r1 + r2), 0.5 * (c1 + c2)
    rnd = rng.random()
    if rnd < 0.2:
        mask[:int(rng.uniform(r1, c_r)), :] = False
    elif rnd < 0.4:
        mask[int(rng.uniform(c_r, r2)):, :] = False
    elif rnd < 0.6:
        mask[:, :int(rng.uniform(c1, c_c))] = False
    elif rnd < 0.8:
        mask[:, int(rng.uniform(c_c, c2)):] = False
    return mask


def _fit_bg(bg: np.ndarray, h: int, w: int, keep_aspect: bool = True) -> np.ndarray:
    """A background resized to (h, w); keep_aspect first crops it top-left to
    the target aspect ratio."""
    if not keep_aspect:
        return imgproc.resize_linear(bg, w, h)
    bh, bw = bg.shape[:2]
    target_ratio = h / w
    if bh / bw > target_ratio:
        bg = bg[: max(int(np.ceil(bw * target_ratio)), 1)]
    else:
        bg = bg[:, : max(int(np.ceil(bh / target_ratio)), 1)]
    return imgproc.resize_linear(bg, w, h)


def replace_background(rng: np.random.Generator, img: np.ndarray, fg_mask: np.ndarray,
                       bg_root: str, truncate_fg: bool = False, bg_type: str = "",
                       num_bg_imgs: int = 10000, keep_aspect: bool = True) -> np.ndarray:
    """Replace the pixels outside the foreground mask with a random image of
    the INPUT.BG_TYPE pool; truncate_fg also occludes part of the
    foreground (`trunc_mask`). An empty pool or a missing file leaves the
    image as it is, as OpenCV's None does in the JAX package."""
    files = _bg_paths_cached(bg_type, bg_root, num_bg_imgs)
    if not files:
        return img
    bg = read_image(files[int(rng.integers(len(files)))])
    if bg is None:
        return img
    h, w = img.shape[:2]
    bg = _fit_bg(bg, h, w, keep_aspect=keep_aspect)[:, :, ::-1]
    if img.dtype != np.uint8:
        scale = 255.0 if img.max() > 1.5 else 1.0
        bg = bg.astype(img.dtype) * (scale / 255.0)
    m = fg_mask.astype(bool)
    if truncate_fg and m.any():
        m = trunc_mask(rng, m)
    out = img.copy()
    out[~m] = bg[~m]
    return out
