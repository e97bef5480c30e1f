"""`catre_tpu_torch/data/jpeg.py` against OpenCV (written against cv2 5.0 with
libjpeg-turbo 3.1.2): the decoder against `cv2.imread` / `cv2.imdecode`, the
round trip against `cv2.imdecode(cv2.imencode(".jpg", q))`, bit for bit.

The fixtures under `tests/data/jpeg/` are a 61 x 83 image written by
`cv2.imencode` as baseline 4:2:0 (q 85), 4:2:2 (q 90), 4:4:4 (q 95),
greyscale (q 80), with a restart marker every 2 MCUs (q 75), with optimized
Huffman tables (q 10), and progressive (q 85); `cv2_imread.npz` holds
`cv2.imread(path, IMREAD_COLOR)` of each. They need no OpenCV to check, so
the card's host checks them too (`chip_smoke.py` phase 9b). `background_*.jpg`
are three 500 x 375 / 375 x 500 images (q 90) for phase 9b's pool."""

import os.path as osp

import numpy as np
import pytest

from catre_tpu_torch.data import jpeg

cv2 = pytest.importorskip("cv2")

FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "jpeg")
DECODABLE = ["baseline_420", "baseline_422", "baseline_444", "greyscale", "restart_markers",
             "optimized_q10"]
SAMPLING = {"420": [], "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111],
            "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111],
            "440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111],
            "411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111]}


def _image(h, w, seed=0):
    """A smooth seeded colour image with noise (uint8 BGR)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + y / 29.0), 128 + 90 * np.cos(x / 11.0 - y / 7.0),
                    (x * 3 + y * 2) % 256], -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", DECODABLE)
def test_fixture_decodes_equal_cv2_imread(name):
    ref = np.load(osp.join(FIXTURES, "cv2_imread.npz"))[name]
    path = osp.join(FIXTURES, name + ".jpg")
    got = jpeg.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("name", ["background_0", "background_1", "background_2"])
def test_background_fixtures_decode_as_cv2_imread(name):
    """The VOC-sized backgrounds (q 90, 4:2:0) of `chip_smoke.py` phase 9b's pool."""
    path = osp.join(FIXTURES, name + ".jpg")
    np.testing.assert_array_equal(jpeg.read_jpeg(path), cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_decode_equals_cv2_over_sizes_and_qualities(sampling):
    """Odd and tiny sizes (partial MCUs, chroma widths of 1 and 2, where
    libjpeg upsamples by replication), qualities 4-100, grey, restart
    markers and optimized tables."""
    for h, w in [(37, 53), (96, 128), (8, 8), (1, 1), (17, 2), (2, 33), (9, 17)]:
        img = _image(h, w, seed=h * w)
        for q in (4, 30, 75, 100):
            for extra in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 3], [cv2.IMWRITE_JPEG_OPTIMIZE, 1]):
                ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q]
                                       + SAMPLING[sampling] + extra)
                got = jpeg.decode_jpeg(enc.tobytes())
                np.testing.assert_array_equal(got, cv2.imdecode(enc, cv2.IMREAD_COLOR),
                                              err_msg=f"{h}x{w} q{q} {extra}")
        if sampling == "420":
            ok, enc = cv2.imencode(".jpg", img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 50])
            np.testing.assert_array_equal(jpeg.decode_jpeg(enc.tobytes()),
                                          cv2.imdecode(enc, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("size", [(37, 53), (96, 128), (120, 160), (1, 1), (17, 2), (16, 16)])
def test_round_trip_equals_cv2_imencode_imdecode(size):
    """`jpeg_round_trip(rgb, q)` == `imdecode(imencode(rgb[..., ::-1], q))[..., ::-1]`
    at every quality the albumentations chain draws, 4-100."""
    img = _image(*size, seed=sum(size))[..., ::-1].copy()         # RGB
    qualities = range(4, 101) if size == (37, 53) else range(4, 101, 8)
    for q in qualities:
        ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])
        ref = cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(jpeg.jpeg_round_trip(img, q), ref, err_msg=f"q{q}")


def test_quality_tables_follow_libjpeg():
    lum, chrom = jpeg.quality_tables(50)
    np.testing.assert_array_equal(lum, jpeg.STD_LUMINANCE)
    np.testing.assert_array_equal(chrom, jpeg.STD_CHROMINANCE)
    assert (jpeg.quality_tables(100)[0] == 1).all()
    assert jpeg.quality_tables(1)[0].max() == 255          # force_baseline clamps at 255
    np.testing.assert_array_equal(jpeg.quality_tables(0)[0], jpeg.quality_tables(1)[0])


def _with_marker(data: bytes, sof: int, precision: int = 8) -> bytes:
    """A baseline file with its SOF0 marker replaced by `sof` and its sample
    precision by `precision`."""
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([sof]) + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


def test_formats_not_read_raise_and_name_themselves(tmp_path):
    with pytest.raises(ValueError, match="progressive JPEG"):
        jpeg.read_jpeg(osp.join(FIXTURES, "progressive.jpg"))
    base = open(osp.join(FIXTURES, "baseline_420.jpg"), "rb").read()
    for sof, name in ((0xC9, "arithmetic-coded sequential"), (0xCA, "arithmetic-coded progressive"),
                      (0xC3, "lossless"), (0xC5, "differential sequential")):
        with pytest.raises(ValueError, match=name):
            jpeg.decode_jpeg(_with_marker(base, sof))
    with pytest.raises(ValueError, match="12-bit JPEG"):
        jpeg.decode_jpeg(_with_marker(base, 0xC1, precision=12))
    np.testing.assert_array_equal(jpeg.decode_jpeg(_with_marker(base, 0xC1)),   # extended, 8-bit
                                  jpeg.decode_jpeg(base))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG....")
    cut = base[:len(base) // 2]
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.decode_jpeg(cut + bytes(range(256)) * 4)
    with pytest.raises(FileNotFoundError):
        jpeg.read_jpeg(str(tmp_path / "absent.jpg"))


def _exif_app1(orientation: int) -> bytes:
    """An APP1 Exif segment with one IFD0 entry, Orientation (0x0112)."""
    tiff = (b"MM\x00\x2a" + (8).to_bytes(4, "big") + (1).to_bytes(2, "big")
            + (0x0112).to_bytes(2, "big") + (3).to_bytes(2, "big") + (1).to_bytes(4, "big")
            + orientation.to_bytes(2, "big") + b"\x00\x00" + (0).to_bytes(4, "big"))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_imread(orientation, tmp_path):
    base = open(osp.join(FIXTURES, "baseline_420.jpg"), "rb").read()
    data = base[:2] + _exif_app1(orientation) + base[2:]
    path = tmp_path / f"o{orientation}.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = jpeg.read_jpeg(str(path))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_idct_of_a_dc_block_and_the_saturating_output():
    coef = np.zeros((3, 8, 8), np.int64)
    coef[0, 0, 0] = 8 * 40            # DC only: every sample 128 + 40
    coef[1, 0, 0] = 8 * 4000          # far out of range: saturates at 255
    coef[2, 0, 0] = -8 * 4000         # and at 0
    out = jpeg.idct_islow(coef)
    assert (out[0] == 168).all() and (out[1] == 255).all() and (out[2] == 0).all()
    blocks = np.full((1, 8, 8), 200, np.uint8)
    assert jpeg.fdct_islow(blocks)[0, 0, 0] == 8 * 8 * (200 - 128)
    assert (jpeg.fdct_islow(blocks)[0].ravel()[1:] == 0).all()
