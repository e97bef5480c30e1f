"""K6 (the main tail in training: forward with argmax, and its backward's
passes) at its bound, %; a forward and its backward share one bound."""

from __future__ import annotations

from .. import flops
from ._share import clouds, points, roofline


def read(ctx):
    return roofline(ctx, "K6", flops.k6(clouds(ctx), points(ctx)), by_forward=True)
