"""JPEG decoding and the lossy round trip of OpenCV's JPEG codec, on numpy.

The JAX package reads its background pool with `cv2.imread(path,
cv2.IMREAD_COLOR)` and compresses images with `cv2.imencode(".jpg", q)` then
`cv2.imdecode` (`catre_tpu/data/aug_color.py:503-507, :756`). OpenCV does both
through libjpeg-turbo; the GPU host has neither. This module computes what
they give, bit for bit:

- `decode_jpeg` / `read_jpeg`: a baseline or extended sequential Huffman JPEG
  (8-bit samples; greyscale, YCbCr or RGB; 4:4:4, 4:2:2, 4:4:0 or 4:2:0;
  restart markers; several scans) -> (H, W, 3) uint8 BGR, with libjpeg-turbo's
  integer IDCT ("islow"), its fancy (triangular) upsampling, its fixed-point
  YCbCr -> RGB and OpenCV's EXIF orientation. Progressive, arithmetic-coded,
  lossless, hierarchical, 12-bit and four-component files raise `ValueError`
  naming their format.
- `jpeg_round_trip`: `imdecode(imencode(img, q))` without the entropy coding,
  which is lossless: libjpeg's quality scaling of the standard tables, its
  fixed-point RGB -> YCbCr, its 4:2:0 downsampling with the alternating bias
  (OpenCV's default sampling), the integer forward DCT and its rounded
  quantisation, then the decoder's inverse path.

Huffman decoding is the one sequential part. Every bit position of a scan
gets its 16-bit window at once; each table then gives, for every position,
the symbol's total length (code and magnitude bits) and its value, so the walk
over the symbols is a few list lookups per symbol.
"""

from __future__ import annotations

import numpy as np

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# libjpeg's standard tables (natural order), scaled by `quality_tables`
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

_SOF_NAMES = {
    0xC3: "lossless", 0xC5: "differential sequential", 0xC6: "differential progressive",
    0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless", 0xC2: "progressive"}

# the IDCT / FDCT constants (CONST_BITS = 13) of libjpeg's jidctint.c / jfdctint.c
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


# ---- the integer DCTs, on (N, 8, 8) int64 blocks

def _idct_pass(i0, i1, i2, i3, i4, i5, i6, i7, shift: int):
    """One 1-D pass of jpeg_idct_islow on the eight input rows / columns."""
    z1 = (i2 + i6) * _F0541
    tmp2 = z1 - i6 * _F1847
    tmp3 = z1 + i2 * _F0765
    tmp0 = (i0 + i4) << _CONST_BITS
    tmp1 = (i0 - i4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i7, i5, i3, i1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [_descale(v, shift) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized (N, 8, 8) coefficients -> (N, 8, 8) uint8 samples, as
    libjpeg-turbo's SIMD "islow": the pass-1 workspace and the output saturate
    (the C code masks the output instead; the two agree on every value an
    encoder produces)."""
    c = coef.astype(np.int64)
    ws = np.stack(_idct_pass(*(c[:, k, :] for k in range(8)),
                             _CONST_BITS - _PASS1_BITS), axis=1)
    ws = np.clip(ws, -32768, 32767)
    out = np.stack(_idct_pass(*(ws[:, :, k] for k in range(8)),
                              _CONST_BITS + _PASS1_BITS + 3), axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _fdct_pass(d0, d1, d2, d3, d4, d5, d6, d7, pass1: bool):
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if pass1:
        o0, o4 = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    else:
        o0, o4 = _descale(tmp10 + tmp11, _PASS1_BITS), _descale(tmp10 - tmp11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    o2 = _descale(z1 + tmp13 * _F0765, shift)
    o6 = _descale(z1 - tmp12 * _F1847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o7 = _descale(tmp4 + z1 + z3, shift)
    o5 = _descale(tmp5 + z2 + z4, shift)
    o3 = _descale(tmp6 + z2 + z3, shift)
    o1 = _descale(tmp7 + z1 + z4, shift)
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> jpeg_fdct_islow's (N, 8, 8) coefficients,
    scaled up by 8 as libjpeg leaves them for its quantiser."""
    d = blocks.astype(np.int64) - 128
    ws = np.stack(_fdct_pass(*(d[:, :, k] for k in range(8)), True), axis=2)
    return np.stack(_fdct_pass(*(ws[:, k, :] for k in range(8)), False), axis=1)


# ---- colour and sampling

def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16          # FIX(1.40200)
    cb_b = (116130 * x + half) >> 16         # FIX(1.77200)
    cr_g = -46802 * x                        # -FIX(0.71414)
    cb_g = -22554 * x + half                 # -FIX(0.34414) + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB, returned as BGR."""
    yy = y.astype(np.int64)
    r = yy + _CR_R[cr]
    g = yy + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yy + _CB_B[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def rgb_to_ycc(rgb: np.ndarray):
    """libjpeg's fixed-point RGB -> YCbCr (jccolor.c), each (H, W) uint8."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    off = (128 << 16) + half - 1
    cb = (-11059 * r - 21709 * g + 32768 * b + off) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off) >> 16
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def _edge(a: np.ndarray, axis: int, lo: int, hi: int) -> np.ndarray:
    """Extend `a` along `axis` by replicating its edge samples."""
    n = a.shape[axis]
    return np.take(a, np.clip(np.arange(-lo, n + hi), 0, n - 1), axis=axis)


def upsample(plane: np.ndarray, h_ratio: int, v_ratio: int, width: int, height: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (downsampled_height,
    downsampled_width) plane by integral (h_ratio, v_ratio), cropped to
    (height, width): fancy (triangular) for 2h1v, 1h2v and 2h2v, box
    replication where libjpeg uses it (2h with a downsampled width of 2 or
    less, and every other ratio)."""
    p = plane.astype(np.int64)
    dw = p.shape[1]
    if (h_ratio == 2 and dw <= 2) or h_ratio > 2 or v_ratio > 2:    # the box methods
        out = np.repeat(np.repeat(p, h_ratio, axis=1), v_ratio, axis=0)
        return out[:height, :width].astype(np.uint8)
    if v_ratio == 2:
        up, down = _edge(p, 0, 1, 0)[:-1], _edge(p, 0, 0, 1)[1:]
        near = 3 * p
        if h_ratio == 2:                                # h2v2: column sums, then across
            rows = [near + up, near + down]
            outs = []
            for cs in rows:
                left, right = _edge(cs, 1, 1, 0)[:, :-1], _edge(cs, 1, 0, 1)[:, 1:]
                o = np.empty((cs.shape[0], 2 * dw), np.int64)
                o[:, 0::2] = (3 * cs + left + 8) >> 4
                o[:, 1::2] = (3 * cs + right + 7) >> 4
                outs.append(o)
        else:                                           # h1v2
            outs = [(near + up + 1) >> 2, (near + down + 2) >> 2]
        out = np.empty((2 * p.shape[0], outs[0].shape[1]), np.int64)
        out[0::2], out[1::2] = outs
    elif h_ratio == 2:                                  # h2v1
        left, right = _edge(p, 1, 1, 0)[:, :-1], _edge(p, 1, 0, 1)[:, 1:]
        out = np.empty((p.shape[0], 2 * dw), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
    else:
        out = p
    return out[:height, :width].astype(np.uint8)


def downsample_h2v2(plane: np.ndarray, out_cols: int, out_rows: int) -> np.ndarray:
    """libjpeg's h2v2_downsample: rows padded to even and columns to
    2 * out_cols by replication, 2 x 2 sums with the bias 1, 2, 1, 2, ... along
    a row, then the rows replicated down to `out_rows`."""
    p = _edge(plane.astype(np.int64), 0, 0, plane.shape[0] % 2)
    p = _edge(p, 1, 0, 2 * out_cols - p.shape[1])
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    d = ((s + bias) >> 2).astype(np.uint8)
    return _edge(d, 0, 0, out_rows - d.shape[0])


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) -> (by * bx, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _unblocks(blocks: np.ndarray, by: int, bx: int) -> np.ndarray:
    return blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


# ---- the lossy round trip of cv2.imencode(".jpg", q) + cv2.imdecode

def quality_tables(quality: int) -> tuple:
    """jpeg_set_quality(quality, force_baseline=TRUE): the luminance and
    chrominance tables, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMINANCE, STD_CHROMINANCE))


def _quantise(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's reciprocal quantiser: |x| / (8 q) rounded half up,
    the sign restored (identical to the reciprocal form over its range)."""
    d = 8 * qtable.reshape(1, 8, 8)
    q = (np.abs(coef) + d // 2) // d
    return np.where(coef < 0, -q, q)


def _code_plane(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Forward DCT, quantisation, dequantisation and IDCT of a plane whose
    sides are multiples of 8."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    coef = _quantise(fdct_islow(_blocks(plane)), qtable) * qtable.reshape(1, 8, 8)
    return _unblocks(idct_islow(coef), by, bx)


def jpeg_round_trip(rgb: np.ndarray, quality: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> what `cv2.imdecode(cv2.imencode(".jpg",
    rgb[..., ::-1], [IMWRITE_JPEG_QUALITY, quality]))[..., ::-1]` gives:
    4:2:0 YCbCr, the islow DCTs, fancy upsampling."""
    h, w = rgb.shape[:2]
    qy, qc = quality_tables(quality)
    y, cb, cr = rgb_to_ycc(rgb)
    ybx, yby = -(-w // 8), -(-h // 8)
    cw, ch = -(-w // 2), -(-h // 2)
    cbx, cby = -(-cw // 8), -(-ch // 8)
    y_rows = -(-h // 16) * 16        # the encoder pads Y to the iMCU height
    yplane = _edge(_edge(y, 1, 0, ybx * 8 - w), 0, 0, y_rows - h)[:yby * 8]
    ydec = _code_plane(yplane, qy)[:h, :w]
    chroma = []
    for c in (cb, cr):
        plane = downsample_h2v2(c, cbx * 8, cby * 8)
        dec = _code_plane(plane, qc)[:ch, :cw]
        chroma.append(upsample(dec, 2, 2, w, h))
    return ycc_to_bgr(ydec, chroma[0], chroma[1])[..., ::-1]


# ---- the decoder

def _huffman_lut(counts: list, symbols: bytes, ac: bool) -> list:
    """A DC or AC table's canonical codes, looked up by the 16-bit window at
    the bit position of a symbol. Where the code and its magnitude bits fit
    in the window the entry holds it all: the run in bits 0-3 (AC), end of
    block in bit 4, the bits to skip in bits 6-10 and the value + 2048 above.
    Else bit 5 is set and bits 6-10 hold the code length (0: no code matches)
    and bits 11-14 the magnitude category."""
    lens, syms, spans = [], [], []
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lens.append(length)
            syms.append(symbols[k])
            spans.append(1 << (16 - length))
            k += 1
    total = sum(spans)
    if total > 1 << 16:
        raise ValueError("bad Huffman table (its code lengths overflow 16 bits)")
    sym_max = max((x & 15 if ac else x for x in syms), default=0)
    if sym_max > (10 if ac else 11):
        raise ValueError(f"bad Huffman table (a magnitude category of {sym_max} bits)")
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    length[:total] = np.repeat(lens, spans)
    sym[:total] = np.repeat(syms, spans)
    size = sym & 15 if ac else sym
    run = sym >> 4 if ac else 0
    bits = length + size
    raw = (np.arange(1 << 16) >> np.maximum(16 - bits, 0)) & ((1 << size) - 1)
    value = raw - (raw < ((1 << size) >> 1)) * ((1 << size) - 1)
    eob = (sym == 0) if ac else np.zeros_like(sym, bool)
    fast = (length > 0) & (bits <= 16)
    entry = np.where(fast, run | (eob << 4) | (bits << 6) | ((value + 2048) << 11),
                     run | 32 | (length << 6) | (size << 11))
    return entry.tolist()


# the value of a magnitude category s coded in s raw bits (JPEG's EXTEND)
_EXTEND = [[r - (1 << s) + 1 if r < (1 << s) >> 1 else r for r in range(1 << s)]
           for s in range(12)]
_WINDOW_PAD = 64             # bit positions past a scan's end that still have a window


def _windows(data: np.ndarray) -> list:
    """The 16 bits starting at every bit position of `data`, zero-padded,
    `_WINDOW_PAD` positions beyond its end."""
    pad = _WINDOW_PAD // 8 + 2
    b = np.concatenate([data, np.zeros(pad, np.uint8)]).astype(np.int32)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = 8 - np.arange(8, dtype=np.int32)
    return ((w24[:, None] >> shifts[None, :]) & 0xFFFF).reshape(-1).tolist()


def _scan_data(data: bytes, pos: int) -> tuple:
    """Entropy-coded bytes from `pos` to the next marker that is not a
    restart: (the unstuffed intervals between restart markers, the end)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0x00) & ~((nxt >= 0xD0) & (nxt <= 0xD7))]
    end = int(ends[0]) if ends.size else arr.size
    body = arr[:end]
    ff = ff[ff < end]
    rst = ff[(arr[ff + 1] >= 0xD0) & (arr[ff + 1] <= 0xD7)]
    keep = np.ones(end, bool)
    keep[ff[arr[ff + 1] == 0x00] + 1] = False      # stuffed zero bytes
    keep[rst] = keep[rst + 1] = False
    bounds = np.concatenate([[0], rst + 2, [end]])
    pieces = [body[a:b][keep[a:b]] for a, b in zip(bounds[:-1], bounds[1:])]
    return pieces, pos + end


class _Frame:
    """A frame header (SOF): the image's size and its components' sampling,
    MCU grid and (quantised, natural-order) coefficient lists."""

    def __init__(self, sof: int, seg: bytes, path):
        if sof in _SOF_NAMES:
            raise ValueError(f"{path}: {_SOF_NAMES[sof]} JPEG is not read (baseline and "
                             "extended sequential Huffman only)")
        self.precision = seg[0]
        if self.precision != 8:
            raise ValueError(f"{path}: {self.precision}-bit JPEG is not read (8-bit samples only)")
        self.height = int.from_bytes(seg[1:3], "big")
        self.width = int.from_bytes(seg[3:5], "big")
        n = seg[5]
        if n not in (1, 3):
            raise ValueError(f"{path}: {n}-component JPEG (CMYK / YCCK) is not read "
                             "(greyscale, YCbCr or RGB only)")
        if self.height == 0:
            raise ValueError(f"{path}: JPEG with its height in a DNL marker is not read")
        self.comps = []
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i: 9 + 3 * i]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        self.hmax = max(c["h"] for c in self.comps)
        self.vmax = max(c["v"] for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            if c["h"] not in (1, 2, 4) or c["v"] not in (1, 2, 4):
                raise ValueError(f"{path}: sampling factor {c['h']}x{c['v']} is not read")
            c["bx"], c["by"] = self.mcux * c["h"], self.mcuy * c["v"]
            c["w"] = -(-self.width * c["h"] // self.hmax)
            c["h_px"] = -(-self.height * c["v"] // self.vmax)
            c["coef"] = [0] * (c["bx"] * c["by"] * 64)


def _decode_scan(frame: _Frame, comps: list, pieces: list, tables: dict, restart: int,
                 path) -> None:
    """Huffman-decode one scan into its components' coefficient lists
    (natural order, quantised)."""
    data = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    starts = np.cumsum([0] + [8 * len(p) for p in pieces]).tolist()
    for _, td, ta in comps:
        for key in ((0, td), (1, ta)):
            if key not in tables:
                raise ValueError(f"{path}: scan uses an undefined Huffman table {key}")
    win = _windows(data)
    # the blocks of one MCU: (scan slot, coefficient offset within the MCU's grid)
    if len(comps) == 1:
        c = frame.comps[comps[0][0]]
        nbx, nby = -(-c["w"] // 8), -(-c["h_px"] // 8)
        offs = [(by * c["bx"] + bx) * 64 for by in range(nby) for bx in range(nbx)]
        layout = [(0, 0)]
        n_mcu = nbx * nby
    else:
        layout = []
        for slot, (ci, _, _) in enumerate(comps):
            c = frame.comps[ci]
            layout += [(slot, (v * c["bx"] + h) * 64) for v in range(c["v"]) for h in range(c["h"])]
        n_mcu = frame.mcux * frame.mcuy
        offs = None
    plan = []
    for slot, off in layout:
        ci, td, ta = comps[slot]
        c = frame.comps[ci]
        plan.append((slot, off, c["h"] * 64, c["v"] * c["bx"] * 64, c["coef"],
                     tables[(0, td)], tables[(1, ta)]))
    ext, zz = _EXTEND, ZIGZAG.tolist()
    pred = [0] * len(comps)
    p = starts[0]
    interval = 0
    corrupt = ValueError(f"{path}: corrupt JPEG data (no Huffman code matches)")
    try:
        for m in range(n_mcu):
            if restart and m and m % restart == 0:
                interval += 1
                p = starts[interval]
                pred = [0] * len(comps)
            if offs is None:
                my, mx = divmod(m, frame.mcux)
            for slot, off, hstep, vstep, coef, dclut, aclut in plan:
                base = offs[m] if offs is not None else off + my * vstep + mx * hstep
                e = dclut[win[p]]
                if e & 32:
                    n = (e >> 6) & 31
                    if not n:
                        raise corrupt
                    size = (e >> 11) & 15
                    pred[slot] += ext[size][win[p + n] >> (16 - size)]
                    p += n + size
                else:
                    pred[slot] += (e >> 11) - 2048
                    p += (e >> 6) & 31
                coef[base] = pred[slot]
                k = 1
                while k < 64:
                    e = aclut[win[p]]
                    if e & 48:
                        if e & 16:          # end of block
                            p += (e >> 6) & 31
                            break
                        n = (e >> 6) & 31
                        if not n:
                            raise corrupt
                        size = (e >> 11) & 15
                        v = ext[size][win[p + n] >> (16 - size)]
                        p += n + size
                    else:
                        v = (e >> 11) - 2048
                        p += (e >> 6) & 31
                    k += e & 15
                    if k > 63:
                        raise ValueError(f"{path}: corrupt JPEG data (a run past coefficient 63)")
                    coef[base + zz[k]] = v
                    k += 1
    except IndexError:
        raise ValueError(f"{path}: corrupt JPEG data (the scan ran past its end)") from None
    if p > starts[interval + 1] + 8:
        raise ValueError(f"{path}: corrupt JPEG data (the scan ran past its end)")


def _exif_orientation(seg: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of an APP1 Exif segment, 1 if absent."""
    if not seg.startswith(b"Exif\x00\x00") or len(seg) < 14:
        return 1
    t = seg[6:]
    order = {b"II": "little", b"MM": "big"}.get(t[:2])
    if order is None:
        return 1
    u16 = lambda o: int.from_bytes(t[o:o + 2], order)          # noqa: E731
    ifd = int.from_bytes(t[4:8], order)
    if ifd + 2 > len(t):
        return 1
    for i in range(u16(ifd)):
        e = ifd + 2 + 12 * i
        if e + 12 > len(t):
            break
        if u16(e) == 0x0112:
            v = u16(e + 8)
            return v if 1 <= v <= 8 else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform for orientations 1-8."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for ax in flips:
        img = np.flip(img, axis=ax)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 BGR, as `cv2.imread(path,
    cv2.IMREAD_COLOR)` gives it. Formats this decoder does not read raise
    `ValueError` and name the format."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt: dict = {}
    tables: dict = {}
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = 1
    orientation = 1
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at byte {pos})")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                tab = np.zeros(64, np.int64)
                tab[ZIGZAG] = vals
                qt[tq] = tab
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                total = sum(counts)
                tables[(tc, th)] = _huffman_lut(counts, seg[i + 17:i + 17 + total], tc == 1)
                i += 17 + total
        elif marker == 0xDD:
            restart = int.from_bytes(seg[:2], "big")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            frame = _Frame(marker, seg, path)
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG is not read")
        elif marker == 0xE0 and seg.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xE1:
            orientation = _exif_orientation(seg)
        elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe, adobe_transform = True, seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: corrupt JPEG (a scan before its frame header)")
            ns = seg[0]
            ids = [c["id"] for c in frame.comps]
            comps = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                if cid not in ids:
                    raise ValueError(f"{path}: corrupt JPEG (scan component {cid})")
                comps.append((ids.index(cid), t >> 4, t & 15))
            ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError(f"{path}: progressive JPEG is not read")
            pieces, pos = _scan_data(data, pos)
            _decode_scan(frame, comps, pieces, tables, restart, path)
    if frame is None:
        raise ValueError(f"{path}: corrupt JPEG (no frame header)")
    planes = []
    for c in frame.comps:
        if c["tq"] not in qt:
            raise ValueError(f"{path}: corrupt JPEG (undefined quantisation table {c['tq']})")
        coef = np.asarray(c["coef"], np.int64).reshape(-1, 64)       # natural order
        coef = (coef * qt[c["tq"]][None, :]).reshape(-1, 8, 8)
        plane = _unblocks(idct_islow(coef), c["by"], c["bx"])[:c["h_px"], :c["w"]]
        hr, vr = frame.hmax // c["h"], frame.vmax // c["v"]
        if hr * c["h"] != frame.hmax or vr * c["v"] != frame.vmax:
            raise ValueError(f"{path}: fractional sampling ({c['h']}x{c['v']} of "
                             f"{frame.hmax}x{frame.vmax}) is not read")
        planes.append(upsample(plane, hr, vr, frame.width, frame.height))
    if len(planes) == 1:
        img = np.repeat(planes[0][:, :, None], 3, axis=2)
    else:
        cids = tuple(c["id"] for c in frame.comps)
        rgb = (not jfif) and ((adobe and adobe_transform == 0) or
                              (not adobe and cids == (82, 71, 66)))
        if rgb:
            img = np.stack([planes[2], planes[1], planes[0]], axis=-1)
        else:
            img = ycc_to_bgr(*planes)
    return apply_orientation(img, orientation) if orientation != 1 else img


def read_jpeg(path) -> np.ndarray:
    """`decode_jpeg` of a file; a missing file raises FileNotFoundError."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
