"""The port's PNG reader and writer (`catre_tpu_torch/data/png.py`) against
OpenCV, and its RLE codec (`data/rle.py`) against the JAX package's
(`catre_tpu/data/nocs.py` over `catre_tpu/native`).

OpenCV writes every row with the Sub filter, so the port's own writer makes
the files with the other four filters, and with one filter type per row at
random. Tolerance 0 everywhere: decoded arrays are bit-equal."""

import struct
import zlib

import numpy as np
import pytest

import cv2

from catre_tpu.data import nocs as jnocs
from catre_tpu_torch.data import png, rle

FORMATS = {"grey16": ((29, 41), np.uint16), "grey8": ((29, 41), np.uint8),
           "bgr8": ((29, 41, 3), np.uint8)}


def _image(fmt, seed=0):
    shape, dtype = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[:, 5:9] = img[:, 4:5]            # flat runs, where the predictors agree
    return img


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_reader_matches_opencv_on_opencv_files(fmt, tmp_path):
    img = _image(fmt)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    _assert_same(png.read_png(path), ref)
    _assert_same(png.read_png(path), img)


def test_reader_matches_opencv_on_a_depth_frame(tmp_path):
    """A 480 x 640 depth frame as the loader meets it: zeros, millimetres."""
    rng = np.random.default_rng(1)
    depth = rng.integers(600, 1600, (480, 640)).astype(np.uint16)
    depth[rng.random((480, 640)) < 0.05] = 0
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, depth)
    _assert_same(png.read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4, "mixed": "mixed",
           "none_sub_up": "nsu"}


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_every_filter_reads_as_opencv_reads_it(fmt, filters, tmp_path):
    img = _image(fmt, seed=2)
    rng = np.random.default_rng(3)
    kind = FILTERS[filters]
    if kind == "mixed":
        kind = rng.integers(0, 5, img.shape[0])
    elif kind == "nsu":                   # the row-at-a-time path
        kind = rng.integers(0, 3, img.shape[0])
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filters=kind)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    _assert_same(ref, img)                # the writer's file, read by OpenCV
    _assert_same(png.read_png(path), ref)


def test_writer_compression_levels_and_refusals(tmp_path):
    img = _image("grey16")
    for level in (0, 1, 9):
        path = str(tmp_path / f"l{level}.png")
        png.write_png(path, img, level=level)
        _assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    with pytest.raises(ValueError, match="write 16- or 8-bit"):
        png.encode_png(img.astype(np.float32))
    with pytest.raises(ValueError, match="row filter 5"):
        png.encode_png(img, filters=5)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_bytes(w, h, depth, colour, interlace=0, row_bytes=None):
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    rows = b"".join(b"\x00" + bytes(row_bytes) for _ in range(h)) if row_bytes else b""
    return (png.SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,depth,interlace,words", [
    (3, 8, 0, "palette"), (4, 8, 0, "greyscale with alpha"), (6, 8, 0, "RGB with alpha"),
    (6, 16, 0, "RGB with alpha"), (2, 16, 0, "16-bit colour"), (0, 16, 1, "interlaced"),
    (0, 4, 0, "4-bit greyscale")])
def test_reader_refuses_what_it_does_not_read(colour, depth, interlace, words):
    data = _png_bytes(4, 2, depth, colour, interlace, row_bytes=[0] * 32)
    with pytest.raises(ValueError, match=words):
        png.decode_png(data)


def test_reader_refuses_corrupt_files(tmp_path):
    good = png.encode_png(_image("grey8"))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + good[6:])
    bad = bytearray(good)
    bad[45] ^= 0xFF                       # inside the IDAT chunk: its CRC fails
    with pytest.raises(ValueError, match="corrupt"):
        png.decode_png(bytes(bad))
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))


def _masks(seed=4, h=23, w=31):
    rng = np.random.default_rng(seed)
    blob = np.zeros((h, w), bool)
    blob[4:15, 6:20] = True
    return {"random": rng.random((h, w)) < 0.4, "blob": blob, "empty": np.zeros((h, w), bool),
            "full": np.ones((h, w), bool), "first_set": np.eye(h, w, dtype=bool)}


def _coco_string(counts):
    """pycocotools' `rleToString`: the counts as a compressed byte string."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


@pytest.mark.parametrize("name", sorted(_masks()))
def test_rle_matches_jax(name):
    mask = _masks()[name]
    enc = rle.binary_mask_to_rle(mask)
    ref = jnocs.binary_mask_to_rle(mask)
    assert enc == {"counts": list(ref["counts"]), "size": list(ref["size"])}
    assert all(type(c) is int for c in enc["counts"])
    _assert_same(rle.rle_to_binary_mask(enc), jnocs.rle_to_binary_mask(ref))
    _assert_same(rle.rle_to_binary_mask(enc), mask)
    coco = {"counts": _coco_string(enc["counts"]), "size": enc["size"]}
    _assert_same(rle.rle_to_binary_mask(coco), jnocs.rle_to_binary_mask(coco))
    _assert_same(rle.rle_to_binary_mask(coco), mask)
    coco["counts"] = coco["counts"].decode("ascii")
    _assert_same(rle.rle_to_binary_mask(coco), mask)


def test_rle_runs_short_of_or_past_the_mask():
    for counts in ([3, 4], [3, 4, 2, 100], [0, 7, 1]):
        _assert_same(rle.rle_decode_uncompressed(counts, 3, 5),
                     jnocs.rle_to_binary_mask({"counts": counts, "size": [3, 5]}))
