"""Device ms a call of the kernels launched under the benchmark's range
around the group sampler (`bench.sampler`)."""

from __future__ import annotations

from ._share import per_call_ms


def read(ctx):
    t = ctx.trace
    return per_call_ms(ctx, t.launched_under(t.kernels, "bench.sampler"))
