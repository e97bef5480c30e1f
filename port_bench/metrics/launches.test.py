"""Device kernels launched a test call (upload, sampler, refine, download)."""

from __future__ import annotations


def read(ctx):
    return len(ctx.trace.kernels) / ctx.calls if ctx.calls else None
