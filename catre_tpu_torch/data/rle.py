"""COCO run-length masks: column-major runs, the zero-run first.

Counterpart of `catre_tpu/native/__init__.py:52-113` (`rle_decode_uncompressed`,
`rle_encode`, `rle_decode_coco_string`) and `catre_tpu/data/nocs.py:258-278`
(`binary_mask_to_rle`, `rle_to_binary_mask`). The JAX package's C codec
(`catre_tpu/native/rle.c`) is not carried (ROADMAP item 15): the runs are
expanded and found with numpy, which leaves no per-count Python loop to speed
up.
"""

from __future__ import annotations

import numpy as np


def rle_decode_uncompressed(counts, h: int, w: int) -> np.ndarray:
    """counts -> (h, w) bool mask. Runs past h * w are cut; a mask the runs
    do not fill stays False after them."""
    counts = np.asarray(counts, dtype=np.int64).reshape(-1)
    values = (np.arange(counts.size) % 2).astype(bool)
    flat = np.zeros(h * w, dtype=bool)
    runs = np.repeat(values, counts)[: h * w]
    flat[: runs.size] = runs
    return flat.reshape((h, w), order="F")


def rle_encode(mask: np.ndarray) -> list:
    """(h, w) mask -> counts, a list of ints (a leading 0 where the first
    pixel is set)."""
    flat = np.asarray(mask).astype(bool).ravel(order="F")
    if flat.size == 0:
        return [0]
    edges = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], edges, [flat.size]])
    runs = np.diff(bounds)
    if flat[0]:
        runs = np.concatenate([[0], runs])
    return runs.tolist()


def rle_decode_coco_string(s, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE byte string (pycocotools `rleFrString`) -> (h, w)
    bool mask."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: list = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return rle_decode_uncompressed(counts, h, w)


def binary_mask_to_rle(mask: np.ndarray) -> dict:
    """Uncompressed COCO RLE of a mask: {"counts": [...], "size": [h, w]}."""
    mask = np.asarray(mask)
    return {"counts": rle_encode(mask), "size": list(mask.shape)}


def rle_to_binary_mask(rle: dict) -> np.ndarray:
    """Uncompressed (list counts) or COCO-compressed (byte string) RLE ->
    (h, w) bool mask."""
    counts = rle["counts"]
    h, w = rle["size"]
    if isinstance(counts, (bytes, str)):
        return rle_decode_coco_string(counts, h, w)
    return rle_decode_uncompressed(counts, h, w)
