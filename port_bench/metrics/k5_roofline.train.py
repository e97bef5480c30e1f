"""K5 (an STN tail in training: forward with argmax, and its backward's
passes) at its bound, %; a forward and its backward share one bound."""

from __future__ import annotations

from .. import flops
from ._share import clouds, points, roofline


def read(ctx):
    return roofline(ctx, "K5", flops.k5(clouds(ctx), points(ctx)), by_forward=True)
