"""K4 (the rotation heads' backward, its `gemm_tn` and sums) at its bf16
bound, %."""

from __future__ import annotations

from .. import flops
from ._share import points, roofline


def read(ctx):
    return roofline(ctx, "K4", flops.k4(ctx.slots_per_call, 2 * points(ctx)))
