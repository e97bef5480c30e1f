"""Peaks of the card and the least time each kernel's work could take.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in float32 on the CUDA cores, 3.35 TB/s of HBM.
A share is stated against the peak of the type the work is computed in.

A kernel's bound is the larger of its operations over the peak and its
bytes (each input read once, each output written once) over the bandwidth,
from the shapes of one launch: the counts of the kernel table in PERF.md,
e.g. K1 0.6254 ms at 512 clouds of 1024 points.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


def k1(clouds: int, points: int) -> float:
    """Main column tail, 128 -> 512 -> 1024 -> max over points (bf16)."""
    rows = clouds * points
    w = 2 * (128 * 512 + 512 * 1024)
    return bound_s(2 * rows * 128 + w + 4 * clouds * 1024, 2 * rows * (128 * 512 + 512 * 1024))


def k2(clouds: int, points: int) -> float:
    """An STN column's tail, 128 -> 1024 -> max over points (bf16)."""
    rows = clouds * points
    return bound_s(2 * rows * 128 + 2 * 128 * 1024 + 4 * clouds * 1024, 2 * rows * 128 * 1024)


def _head(objects: int, points: int):
    head_flops = 2 * points * (64 * 512 + 2 * 256 * 256)      # both heads, layers 0 and 1
    w_head = 2 * (64 * 512 + 2 * 256 * 256)
    return head_flops, w_head


def k3(objects: int, points: int) -> float:
    """Both rotation heads of `objects` objects of `points` points (bf16)."""
    flops, w = _head(objects, points)
    return bound_s(objects * (2 * points * 64 + 4 * 2 * 512) + w, objects * flops)


def k4(objects: int, points: int) -> float:
    """The rotation heads' backward: the forward again and two products per
    forward product (bf16)."""
    flops, w = _head(objects, points)
    return bound_s(objects * ((2 + 4) * points * 64 + 4 * 4 * 512) + 3 * w, objects * 3 * flops)


def k5(clouds: int, points: int) -> float:
    """An STN tail in training: the forward (128 -> 1024, max and argmax)
    and the backward's parts that do not depend on the argmax rows: dx
    written once, three length-128 float32 products per (cloud, channel)."""
    rows, cin, cout = clouds * points, 128, 1024
    fwd = bound_s(2 * rows * cin + 2 * cout * cin + 8 * clouds * cout, 2 * rows * cin * cout)
    bwd = bound_s(2 * rows * cin + 8 * clouds * cout + 2 * cout * cin + 4 * cout * (cin + 1),
                  3 * 2 * clouds * cout * cin, "float32")
    return fwd + bwd


def k6(clouds: int, points: int) -> float:
    """The main tail in training: the forward (128 -> 512 -> 1024, max and
    argmax) and the backward counted at one argmax row a cloud (the rows the
    argmax picks depend on the data; more rows only raise the bound)."""
    rows, cin, chid, cout = clouds * points, 128, 512, 1024
    w = 2 * (chid * cin + cout * chid)
    fwd = bound_s(2 * rows * cin + w + 8 * clouds * cout, 2 * rows * (cin * chid + chid * cout))
    bwd = bound_s(2 * clouds * cin + 2 * rows * cin + 8 * clouds * cout + w
                  + 4 * (chid * (cin + 1) + cout * (chid + 1)),
                  2 * (3 * clouds * cin * chid + 2 * clouds * cout * chid))
    return fwd + bwd
