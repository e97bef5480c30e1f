"""K1 (main column tail, 128 -> 512 -> 1024 -> max) at its bf16 bound, %:
one launch takes both clouds of every slot."""

from __future__ import annotations

from .. import flops
from ._share import clouds, points, roofline


def read(ctx):
    return roofline(ctx, "K1", flops.k1(clouds(ctx), points(ctx)))
