"""K2 (an STN column's tail, 128 -> 1024 -> max) at its bf16 bound, %."""

from __future__ import annotations

from .. import flops
from ._share import clouds, points, roofline


def read(ctx):
    return roofline(ctx, "K2", flops.k2(clouds(ctx), points(ctx)))
