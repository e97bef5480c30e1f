"""K3 (both rotation heads, layers 0 and 1 over every point) at its bf16
bound, %."""

from __future__ import annotations

from .. import flops
from ._share import points, roofline


def read(ctx):
    return roofline(ctx, "K3", flops.k3(ctx.slots_per_call, 2 * points(ctx)))
