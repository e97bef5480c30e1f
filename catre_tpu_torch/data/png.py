"""PNG reader and writer on `zlib` and numpy.

It stands in for the two OpenCV calls of the JAX package, `cv2.imread(path,
cv2.IMREAD_UNCHANGED)` in `catre_tpu/data/loader.py::load_depth` (:190) and
`cv2.imwrite` in `bench.py:62`, and returns what the first returns:

- 16-bit greyscale -> (H, W) uint16 (big-endian in the file, native here);
- 8-bit greyscale -> (H, W) uint8;
- 8-bit RGB -> (H, W, 3) uint8 in BGR order, OpenCV's, so that callers index
  the channels as the JAX code does.

Anything else raises `ValueError` and names the format: interlaced, palette,
alpha, 16-bit colour, or greyscale below 8 bits. All five row filters are
read (None, Sub, Up, Average, Paeth), the type varying per row. None, Sub and
Up rows are undone a row (or a run of rows) at a time; a file with any
Average or Paeth row, whose bytes depend on the pixel to their left, is undone
by sweeping the anti-diagonals (row + column = t) of all rows at once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)

# colour type -> (channels, name)
_COLOUR = {0: (1, "greyscale"), 2: (3, "RGB"), 3: (1, "palette"),
           4: (2, "greyscale with alpha"), 6: (4, "RGB with alpha")}


def _header(data: bytes, path) -> tuple:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, chunks = 8, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 \
                or struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: truncated or corrupt {kind!r} chunk")
        chunks.append((kind, body))
        pos += 12 + length
        if kind == b"IEND":
            break
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if colour not in _COLOUR or comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG format (colour type {colour}, compression "
                         f"{comp}, filter method {filt})")
    name = _COLOUR[colour][1]
    if interlace:
        raise ValueError(f"{path}: interlaced PNG ({name}, {depth}-bit) is not read")
    if colour != 0 and colour != 2:
        raise ValueError(f"{path}: {name} PNG ({depth}-bit) is not read")
    if colour == 2 and depth != 8:
        raise ValueError(f"{path}: {depth}-bit colour PNG is not read (8-bit RGB only)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: {depth}-bit {name} PNG is not read (8 or 16 bits)")
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    return h, w, depth, _COLOUR[colour][0], idat


def _sub_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo Sub on (n, stride) rows: a running byte sum per lane."""
    n, stride = raw.shape
    lanes = raw.reshape(n, stride // bpp, bpp)
    return np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(n, stride)


def _sweep(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo every filter type at once. Pixel (r, c) reads (r, c - 1), (r - 1,
    c) and (r - 1, c - 1), all on earlier anti-diagonals t = r + c, so one
    step takes a whole diagonal. Stored skewed, pixel (r, c) at [t + 2, r + 1]
    of a zero-padded array, each diagonal is one contiguous row: its left and
    upper neighbours lie in row t + 1, its upper-left neighbour in row t."""
    h, stride = raw.shape
    w = stride // bpp
    r_idx = np.arange(h)[:, None]
    t_idx = r_idx + np.arange(w)[None, :]
    skew_raw = np.zeros((h + w, h, bpp), np.int16)
    skew_raw[t_idx, r_idx] = raw.reshape(h, w, bpp)
    rec = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    masks = [(ftype == k).astype(np.int16)[:, None] for k in range(SUB, PAETH + 1)]
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h, t + 1)           # the rows on diagonal t
        left, up, up_left = rec[t + 1, lo + 1:hi + 1], rec[t + 1, lo:hi], rec[t, lo:hi]
        pa, pb = np.abs(up - up_left), np.abs(left - up_left)
        pc = np.abs(left + up - 2 * up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        m_sub, m_up, m_avg, m_paeth = (m[lo:hi] for m in masks)
        pred = m_sub * left + m_up * up + m_avg * ((left + up) >> 1) + m_paeth * paeth
        rec[t + 2, lo + 1:hi + 1] = (skew_raw[t, lo:hi] + pred) & 0xFF
    return rec[t_idx + 2, r_idx + 1].astype(np.uint8).reshape(h, stride)


def unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) filtered bytes and (H,) filter types -> the image bytes."""
    if ftype.size and int(ftype.max()) > PAETH:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    if ((ftype == AVERAGE) | (ftype == PAETH)).any():
        return _sweep(raw, ftype, bpp)
    out = raw.copy()
    sub = ftype == SUB
    if sub.any():
        out[sub] = _sub_rows(raw[sub], bpp)
    # a run of Up rows is its first row's predecessor plus the running sum
    up = np.flatnonzero(ftype == UP)
    if up.size:
        starts = up[np.concatenate([[True], np.diff(up) > 1])]
        for r0 in starts:
            r1 = r0
            while r1 + 1 < len(ftype) and ftype[r1 + 1] == UP:
                r1 += 1
            block = np.cumsum(raw[r0:r1 + 1], axis=0, dtype=np.uint8)
            if r0 > 0:
                block += out[r0 - 1]
            out[r0:r1 + 1] = block
    return out


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG bytes -> the array `cv2.imdecode(..., IMREAD_UNCHANGED)` gives."""
    h, w, depth, channels, idat = _header(data, path)
    bpp = channels * depth // 8
    stride = w * bpp
    try:
        flat = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    if len(flat) != h * (stride + 1):
        raise ValueError(f"{path}: {len(flat)} bytes of image data, want {h * (stride + 1)}")
    rows = np.frombuffer(flat, np.uint8).reshape(h, stride + 1)
    img = unfilter(rows[:, 1:], rows[:, 0], bpp)
    if depth == 16:
        img = img.reshape(h, w, 2)
        return ((img[..., 0].astype(np.uint16) << 8) | img[..., 1]).astype(np.uint16)
    if channels == 3:
        return np.ascontiguousarray(img.reshape(h, w, 3)[..., ::-1])
    return img.reshape(h, w)


def read_png(path) -> np.ndarray:
    """`cv2.imread(path, cv2.IMREAD_UNCHANGED)` for the formats above; a
    missing file raises FileNotFoundError."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


# ---- the writer

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(img: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Forward filters on (H, stride) bytes: each row's prediction reads the
    image itself, so every row filters at once."""
    x = img.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(up - up_left), np.abs(left - up_left), np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    pred = np.choose(ftype.astype(np.int64)[:, None],
                     [np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filters=SUB, level: int = 6) -> bytes:
    """(H, W) uint16 or uint8 greyscale, or (H, W, 3) uint8 BGR -> PNG bytes.
    `filters`: one type for every row, or one per row."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, colour, data = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, colour, data = 8, 0, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, colour, data = 8, 2, img[..., ::-1]
    else:
        raise ValueError(f"write 16- or 8-bit greyscale or 8-bit BGR, not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    bpp = data.size // (h * w) if h * w else 1
    rows = np.ascontiguousarray(data).reshape(h, w * bpp)
    ftype = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    if ftype.size and int(ftype.max()) > PAETH:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    body = np.concatenate([ftype[:, None], _filter_rows(rows, ftype, bpp)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filters=SUB, level: int = 6) -> None:
    """Write `img` (see `encode_png`) to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filters, level))
