"""Colour augmentation and background replacement of the port
(`catre_tpu_torch/data/aug_color.py`, `data/imgproc.py`) against the JAX
package's `catre_tpu/data/aug_color.py` run on OpenCV (written against cv2 5.0).

- The ops JAX computes in numpy (CoarseDropout, Add, Invert, Multiply,
  LinearContrast, AugmentRGB, the albumentations noise, brightness /
  contrast, RGB shift, gamma, invert, flips, transpose, rot90), the
  combinators, `build_bg_paths` for every source and `trunc_mask`: bit-equal,
  and the generator's next draw equal afterwards.
- The OpenCV calls (`imgproc.py`): GaussianBlur over the `aae` sigmas 0-1.2,
  blur, medianBlur, filter2D (motion, sharpen, emboss), line, resize, RGB <->
  HSV, RGB <-> Lab and CLAHE. The bound is 1 grey level; against cv2 5.0's
  AVX2 paths every one of them is bit-equal (share of pixels that differ: 0),
  which the tests hold too.
- The four COLOR_AUG_TYPE families (aae, roi10d, code with the reference's
  chain string, code_albu with the reference's albumentations chain, JPEG
  round trip included): bit-equal over 40 seeds each.
- `replace_background` over a pool of JPEG, PNG and BMP files, with and
  without TRUNCATE_FG and BG_KEEP_ASPECT_RATIO: bit-equal; a missing file or
  an empty pool leaves the image; formats not read raise.
- The loaders: the JAX `CATRELoader(phase="train")` (mean-shape and mug
  tables patched, its draws handed to the port) against the port's, under
  colour augmentation and background replacement: every field and
  `pcl_rgb` bit-equal over two groups, the clouds within the 2 ulp of the
  jitted JAX loader (`tests/test_torch_train_loader.py`).
"""

import itertools

import numpy as np
import pytest

from catre_tpu.data import aug_color as J
from catre_tpu_torch.data import aug_color as P
from catre_tpu_torch.data import imgproc, jpeg

from test_color_aug import _ALBU_REF_CHAIN
from test_torch_train_loader import _jax, _patched, _port, split  # noqa: F401

cv2 = pytest.importorskip("cv2")

AAE_CODE = """Sequential([
    Sometimes(0.5, CoarseDropout( p=0.2, size_percent=0.05) ),
    Sometimes(0.5, GaussianBlur(1.2*np.random.rand())),
    Sometimes(0.5, Add((-25, 25), per_channel=0.3)),
    Sometimes(0.3, Invert(0.2, per_channel=True)),
    Sometimes(0.5, Multiply((0.6, 1.4), per_channel=0.5)),
    Sometimes(0.5, Multiply((0.6, 1.4))),
    Sometimes(0.5, LinearContrast((0.5, 2.2), per_channel=0.3))
    ], random_order = False)"""
FAMILIES = {"aae": "", "roi10d": "", "code": AAE_CODE, "code_albu": _ALBU_REF_CHAIN}


def _image(h=96, w=128, seed=0):
    """Smooth colour structure with noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 9.0 + y / 23.0), 128 + 90 * np.cos(y / 7.0 - x / 31.0),
                    (x + 2 * y) % 256], -1) + rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _same_run(make_j, make_p, img, seeds=range(8)):
    """Both ops on copies of `img` from the same generator: equal outputs
    and the same next draw."""
    for s in seeds:
        r1, r2 = np.random.default_rng(s), np.random.default_rng(s)
        a, b = make_j()(r1, img.copy()), make_p()(r2, img.copy())
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"seed {s}")
        assert r1.random() == r2.random(), f"seed {s}: the draws diverged"


NUMPY_OPS = {
    "CoarseDropout": lambda m: m.CoarseDropout(p=0.2, size_percent=0.05),
    "Add": lambda m: m.Add((-25, 25), per_channel=0.3),
    "Invert": lambda m: m.Invert(0.5, per_channel=True),
    "Invert_whole": lambda m: m.Invert(0.5),
    "Multiply": lambda m: m.Multiply((0.6, 1.4), per_channel=0.5),
    "LinearContrast": lambda m: m.LinearContrast((0.5, 2.2), per_channel=0.3),
    "AugmentRGB": lambda m: m.AugmentRGB(),
    "GaussNoise": lambda m: m.AlbuGaussNoise(p=1.0),
    "IAAAdditiveGaussianNoise": lambda m: m.AlbuIAAAdditiveGaussianNoise(p=1.0),
    "RandomBrightnessContrast": lambda m: m.AlbuRandomBrightnessContrast(0.4, 0.6, p=1.0),
    "RandomContrast": lambda m: m.AlbuRandomContrast(limit=0.9, p=0.7),
    "RandomBrightness": lambda m: m.AlbuRandomBrightness(limit=1.2, p=0.7),
    "RGBShift": lambda m: m.AlbuRGBShift(105, 45, 40, p=0.5),
    "RandomGamma": lambda m: m.AlbuRandomGamma((80, 120), p=1.0),
    "InvertImg": lambda m: m.AlbuInvertImg(p=0.5),
    "HorizontalFlip": lambda m: m.AlbuHorizontalFlip(p=0.5),
    "Flip": lambda m: m.AlbuFlip(p=1.0),
    "Transpose": lambda m: m.AlbuTranspose(p=0.5),
    "RandomRotate90": lambda m: m.AlbuRandomRotate90(p=1.0),
    "AlbuCoarseDropout": lambda m: m.AlbuCoarseDropout(max_holes=6, max_height=9, max_width=7,
                                                       min_holes=2, min_height=3, p=0.8),
    "Sequential_random_order": lambda m: m.Sequential(
        [m.Add((-5, 5)), m.Invert(0.5), m.Multiply((0.9, 1.1))], random_order=True),
    "Sometimes_OneOf": lambda m: m.Sometimes(0.7, m.OneOf([m.Add((-9, 9)), m.Invert(1.0)])),
    "AlbuOneOf_Compose": lambda m: m.AlbuCompose([
        m.AlbuOneOf([m.AlbuInvertImg(p=0.2), m.AlbuRGBShift(p=0.5), m.AlbuRandomGamma(p=0.3)],
                    p=0.9), m.AlbuInvertImg(p=0.4)], p=0.8),
}


@pytest.mark.parametrize("name", sorted(NUMPY_OPS))
def test_numpy_ops_bit_equal_with_the_same_draws(name):
    make = NUMPY_OPS[name]
    _same_run(lambda: make(J), lambda: make(P), _image(48, 64, seed=len(name)))


def test_gaussian_blur_over_the_aae_sigmas():
    img = _image()
    for sigma in np.linspace(0.0, 1.2, 61)[1:]:
        ref = cv2.GaussianBlur(img, (0, 0), float(sigma))
        got = imgproc.gaussian_blur(img, float(sigma))
        assert np.abs(ref.astype(int) - got).max() <= 1
        np.testing.assert_array_equal(got, ref, err_msg=f"sigma {sigma}")
    assert imgproc.gaussian_kernel_q8(1.0).sum() == 256


def test_blurs_filters_and_lines_against_opencv():
    rng = np.random.default_rng(4)
    for h, w in [(96, 128), (31, 45)]:
        img = _image(h, w, seed=w)
        for k in range(3, 8):
            np.testing.assert_array_equal(imgproc.box_blur(img, k), cv2.blur(img, (k, k)))
        for k in (3, 5, 7):
            np.testing.assert_array_equal(imgproc.median_blur(img, k), cv2.medianBlur(img, k))
        for _ in range(4):
            li, s = rng.uniform(0.5, 1.0), rng.uniform(0.2, 0.7)
            for kernel in (np.array([[-1, -1, -1], [-1, 8 + li, -1], [-1, -1, -1]], np.float32),
                           np.array([[-1 - s, -s, 0], [-s, 1, s], [0, s, 1 + s]], np.float32)):
                np.testing.assert_array_equal(imgproc.filter2d(img, kernel),
                                              cv2.filter2D(img, -1, kernel))
            k = int(rng.integers(3, 8)) | 1
            pts = [tuple(int(v) for v in rng.integers(k, size=2)) for _ in range(2)]
            ref, got = np.zeros((k, k), np.float32), np.zeros((k, k), np.float32)
            cv2.line(ref, pts[0], pts[1], 1.0, thickness=1)
            imgproc.draw_line(got, pts[0], pts[1], 1.0)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(imgproc.filter2d(img, got / got.sum()),
                                          cv2.filter2D(img, -1, ref / ref.sum()))
    for _ in range(2000):                       # every direction of short lines
        k = int(rng.integers(3, 12))
        pts = [tuple(int(v) for v in rng.integers(k, size=2)) for _ in range(2)]
        ref, got = np.zeros((k, k), np.float32), np.zeros((k, k), np.float32)
        cv2.line(ref, pts[0], pts[1], 1.0, thickness=1)
        imgproc.draw_line(got, pts[0], pts[1], 1.0)
        assert np.array_equal(got, ref), (k, pts)


@pytest.mark.parametrize("src", [(375, 500), (500, 375), (960, 1280), (97, 131), (480, 640),
                                 (7, 9), (1000, 1500)])
def test_resize_linear_against_opencv(src):
    img = _image(*src, seed=src[0])
    for h, w in [(480, 640), (96, 128), (50, 130)]:
        np.testing.assert_array_equal(imgproc.resize_linear(img, w, h), cv2.resize(img, (w, h)))


def test_colour_spaces_over_every_colour():
    every = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                     -1).reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.rgb_to_hsv(every), cv2.cvtColor(every, cv2.COLOR_RGB2HSV))
    np.testing.assert_array_equal(imgproc.rgb_to_lab(every), cv2.cvtColor(every, cv2.COLOR_RGB2LAB))
    np.testing.assert_array_equal(imgproc.lab_to_rgb(every), cv2.cvtColor(every, cv2.COLOR_LAB2RGB))
    hsv = every[:180 * 16].copy()
    hsv[..., 0] %= 180
    np.testing.assert_array_equal(imgproc.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    for w in (100, 131, 33):                    # rows that end in the scalar tail
        part = hsv[:40, :w].copy()
        np.testing.assert_array_equal(imgproc.hsv_to_rgb(part),
                                      cv2.cvtColor(part, cv2.COLOR_HSV2RGB))


def test_clahe_against_opencv():
    for h, w in [(96, 128), (97, 131), (40, 33)]:
        lab = cv2.cvtColor(_image(h, w, seed=h), cv2.COLOR_RGB2LAB)
        for clip in (1.0, 1.37, 2.0, 3.9):
            ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(lab[..., 0])
            np.testing.assert_array_equal(imgproc.clahe(lab[..., 0], clip), ref)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_bit_equal_with_the_same_draws(family):
    code = FAMILIES[family]
    img = _image()
    for seed in range(40):
        np.random.seed(seed)            # the reference's chain string draws np.random.rand()
        ja = J.build_color_augmentor(family, code, seed=seed)
        np.random.seed(seed)
        pa = P.build_color_augmentor(family, code, seed=seed)
        _same_run(lambda: ja, lambda: pa, img, seeds=[seed + 100])


def test_jpeg_compression_over_the_chain_qualities():
    img = _image(37, 53)
    _same_run(lambda: J.AlbuJpegCompression(4, 100, p=1.0),
              lambda: P.AlbuJpegCompression(4, 100, p=1.0), img, seeds=range(30))


def test_colour_augment_on_floats_and_by_default():
    img = _image().astype(np.float32) / 255.0
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    a, b = J.color_augment(r1, img), P.color_augment(r2, img)
    assert b.dtype == np.float32 and 0 <= b.min() and b.max() <= 1
    np.testing.assert_array_equal(a, b)
    assert r1.random() == r2.random()


def test_selector_errors():
    with pytest.raises(ValueError, match="requires INPUT.COLOR_AUG_CODE"):
        P.build_color_augmentor("code_albu", "")
    with pytest.raises(ValueError, match="'nope' is not supported"):
        P.build_color_augmentor("nope")
    for name in ("ShiftScaleRotate", "IAAPerspective", "OpticalDistortion", "GridDistortion",
                 "IAAPiecewiseAffine"):
        with pytest.raises(NotImplementedError, match="geometric warp"):
            P.build_color_augmentor("code_albu", f"Compose([{name}(p=0.5)])")


# ---- backgrounds

def _pool(root):
    """A flat directory of JPEG (4:2:0 and greyscale), PNG and 24-bit BMP
    backgrounds of several aspect ratios, written by OpenCV."""
    root.mkdir(exist_ok=True)
    for i, (h, w) in enumerate([(375, 500), (500, 375), (60, 200), (96, 128)]):
        img = _image(h, w, seed=10 + i)[..., ::-1]
        cv2.imwrite(str(root / f"bg{i}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 70 + 5 * i])
    cv2.imwrite(str(root / "grey.jpg"), _image(80, 90, seed=3)[..., 0])
    cv2.imwrite(str(root / "bg.png"), _image(70, 100, seed=4))
    cv2.imwrite(str(root / "bg.bmp"), _image(45, 61, seed=5))
    (root / "notes.txt").write_text("not an image")
    return str(root)


def _voc(root):
    """A VOCdevkit-shaped root: JPEGImages and diningtable_trainval.txt."""
    (root / "JPEGImages").mkdir(parents=True)
    (root / "ImageSets" / "Main").mkdir(parents=True)
    lines = []
    for i in range(6):
        cv2.imwrite(str(root / "JPEGImages" / f"2008_{i:06d}.jpg"), _image(40, 50, seed=i))
        lines.append(f"2008_{i:06d} {1 if i % 2 else -1}")
    (root / "ImageSets" / "Main" / "diningtable_trainval.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_bg_paths_for_every_source(tmp_path):
    pool, voc = _pool(tmp_path / "pool"), _voc(tmp_path / "voc")
    for bg_type, root in (("", pool), ("file_dir", pool), ("coco", pool), ("VOC_table", voc),
                          ("VOC", voc), ("SUN2012", voc), ("file_dir", str(tmp_path / "none"))):
        for n, seed in ((3, 0), (10000, 5)):
            assert (P.build_bg_paths(bg_type, root, n, seed=seed)
                    == J.build_bg_paths(bg_type, root, n, seed=seed)), (bg_type, n)
    assert len(P.build_bg_paths("VOC_table", voc)) == 3
    with pytest.raises(NotImplementedError, match="SUN_RGBD"):
        P.build_bg_paths("SUN_RGBD", voc)
    with pytest.raises(ValueError, match="not supported"):
        P.build_bg_paths("imagenet", voc)


def test_trunc_mask_bit_equal_with_the_same_draws():
    mask = np.zeros((60, 80), bool)
    mask[12:41, 20:67] = True
    for s in range(30):
        r1, r2 = np.random.default_rng(s), np.random.default_rng(s)
        np.testing.assert_array_equal(J.trunc_mask(r1, mask), P.trunc_mask(r2, mask))
        assert r1.random() == r2.random()
    assert not P.trunc_mask(np.random.default_rng(0), np.zeros((5, 5), bool)).any()


@pytest.mark.parametrize("truncate,keep", [(False, True), (True, True), (True, False)])
def test_replace_background_bit_equal(tmp_path, truncate, keep):
    pool = _pool(tmp_path / "pool")
    img = _image(96, 128, seed=9)
    mask = np.zeros((96, 128), bool)
    mask[30:70, 40:100] = True
    picked = set()
    for s in range(16):
        r1, r2 = np.random.default_rng(s), np.random.default_rng(s)
        a = J.replace_background(r1, img, mask, pool, truncate_fg=truncate, keep_aspect=keep)
        b = P.replace_background(r2, img, mask, pool, truncate_fg=truncate, keep_aspect=keep)
        np.testing.assert_array_equal(a, b, err_msg=f"seed {s}")
        assert r1.random() == r2.random()
        picked.add(tuple(b[0, 0]))
    assert len(picked) > 3                      # several of the pool's files were drawn


def test_read_image_as_imread_and_what_raises(tmp_path):
    pool = tmp_path / "pool"
    _pool(pool)
    for f in sorted(pool.iterdir()):
        if f.suffix != ".txt":
            np.testing.assert_array_equal(P.read_image(str(f)), cv2.imread(str(f), cv2.IMREAD_COLOR))
    assert P.read_image(str(tmp_path / "absent.jpg")) is None
    g16 = (np.arange(12 * 9).reshape(12, 9) * 601).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "g16.png"), g16)
    np.testing.assert_array_equal(P.read_image(str(tmp_path / "g16.png")),
                                  cv2.imread(str(tmp_path / "g16.png"), cv2.IMREAD_COLOR))
    bmp = (pool / "bg.bmp").read_bytes()
    rle = bmp[:30] + (1).to_bytes(4, "little") + bmp[34:]
    (tmp_path / "rle.bmp").write_bytes(rle)
    with pytest.raises(ValueError, match="compressed BMP"):
        P.read_image(str(tmp_path / "rle.bmp"))
    cv2.imwrite(str(tmp_path / "grey.bmp"), _image(8, 8)[..., 0])
    with pytest.raises(ValueError, match="8-bit BMP"):
        P.read_image(str(tmp_path / "grey.bmp"))
    ok, enc = cv2.imencode(".jpg", _image(16, 16), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    (tmp_path / "prog.jpg").write_bytes(enc.tobytes())
    with pytest.raises(ValueError, match="progressive JPEG"):
        P.read_image(str(tmp_path / "prog.jpg"))
    (tmp_path / "x.gif").write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="other than JPEG, PNG and BMP"):
        P.read_image(str(tmp_path / "x.gif"))
    # a progressive background in the pool raises out of replace_background
    only = tmp_path / "only"
    only.mkdir()
    (only / "prog.jpg").write_bytes(enc.tobytes())
    with pytest.raises(ValueError, match="progressive JPEG"):
        P.replace_background(np.random.default_rng(0), _image(16, 16), np.zeros((16, 16), bool),
                             str(only))


def test_missing_file_or_empty_pool_keeps_the_image(tmp_path):
    img, mask = _image(16, 16), np.zeros((16, 16), bool)
    assert P.replace_background(np.random.default_rng(0), img, mask, str(tmp_path / "x")) is img
    voc = tmp_path / "voc"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "ImageSets" / "Main" / "diningtable_trainval.txt").write_text("2008_1 1\n")
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    a = J.replace_background(r1, img, mask, str(voc), bg_type="VOC_table")
    b = P.replace_background(r2, img, mask, str(voc), bg_type="VOC_table")
    assert a is img and b is img and r1.random() == r2.random()


# ---- the loaders

LOADER_CASES = {  # name: LoaderConfig fields beyond PCL_WITH_COLOR and the pool
    "aae_bg_truncate": dict(color_aug_prob=0.8, change_bg_prob=0.7, truncate_fg=True,
                            num_workers=2),           # the port's images in two threads
    "roi10d": dict(color_aug_prob=1.0, color_aug_type="roi10d"),
    "code_albu_bg_stretch": dict(color_aug_prob=1.0, color_aug_type="code_albu",
                                 color_aug_code=_ALBU_REF_CHAIN, change_bg_prob=1.0,
                                 bg_keep_aspect_ratio=False),
    "bg_only_syn_only": dict(color_aug_prob=1.0, color_aug_syn_only=True, change_bg_prob=1.0),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_train_loader_colour_matches_jax(case, split, tmp_path):  # noqa: F811
    pool = _pool(tmp_path / "pool")
    kw = dict(pcl_with_color=True, aug_depth=False, bg_image_dir=pool, **LOADER_CASES[case])
    ref = list(itertools.islice(iter(_jax(split, **{k: v for k, v in kw.items()
                                                    if k != "num_workers"})), 2))
    port = list(itertools.islice(iter(_port(split, **kw)), 2))
    plain = list(itertools.islice(iter(_port(split, pcl_with_color=True, aug_depth=False)), 2))
    moved = False
    for a, b, c in zip(ref, port, plain):
        assert a["scene_im_ids"] == b["scene_im_ids"]
        assert set(a) == set(b)
        for k in set(b) - {"pcl", "scene_im_ids", "file_names"}:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        x, y = np.asarray(a["pcl"]), np.asarray(b["pcl"])       # the jitted loader's bound
        assert (np.abs(x - y) <= 2 * np.spacing(np.abs(x[..., 2:3]))).all()
        assert b["pcl_rgb"].dtype == np.float32
        assert 0.0 <= b["pcl_rgb"].min() and b["pcl_rgb"].max() <= 1.0
        np.testing.assert_array_equal(b["pcl"], c["pcl"])      # the aug touches the RGB only
        moved |= not np.array_equal(b["pcl_rgb"], c["pcl_rgb"])
    assert moved


def test_jpeg_module_is_what_the_albu_chain_calls():
    """AlbuJpegCompression is the round trip of `jpeg.py` (no other codec)."""
    img = _image(24, 40)
    rng = np.random.default_rng(1)
    q = int(np.random.default_rng(1).integers(4, 101))
    np.testing.assert_array_equal(P.AlbuJpegCompression(4, 100, p=1.0).apply(rng, img),
                                  jpeg.jpeg_round_trip(img, q))


def test_a_decoded_cache_is_refused_with_colour_as_in_jax(split, tmp_path):  # noqa: F811
    """The shipped config's CACHE_DECODED="device" with PCL_WITH_COLOR and the
    colour keys: both loaders refuse it by the same words."""
    from catre_tpu.config.build import loader_config_from as j_loader_config_from
    from catre_tpu.config.loader import load_config as j_load_config
    from catre_tpu.data import loader as jl
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, loader_config_from
    from catre_tpu_torch.config.loader import load_config
    from catre_tpu_torch.data import loader as tl

    keys = {"PCL_WITH_COLOR": True, "COLOR_AUG_PROB": 1.0, "CHANGE_BG_PROB": 1.0,
            "BG_IMGS_ROOT": str(tmp_path)}
    cfg, jcfg = load_config(str(FLAGSHIP_CONFIG)), j_load_config(str(FLAGSHIP_CONFIG))
    for c in (cfg, jcfg):
        c.INPUT.update(keys)
    port, ref = loader_config_from(cfg, "train"), j_loader_config_from(jcfg, "train")
    assert port.cache_decoded == ref.cache_decoded == "device"
    for make, lcfg in ((lambda c: jl.CATRELoader(split, c, phase="train"), ref),
                       (lambda c: tl.CATRELoader(split, c, phase="train", device="cpu",
                                                 mean_points=np.zeros((6, 1024, 3), np.float32)),
                        port)):
        with pytest.raises(ValueError, match="cache_decoded supports the depth-only path"):
            make(lcfg)
