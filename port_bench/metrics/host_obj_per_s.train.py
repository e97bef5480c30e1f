"""Objects (rows trained, or real objects refined) a second of the traced
window on the host's clock: the host-paced rate of a cell whose end-to-end
rate is taken over the device's busy time. The profiler slows the host, so
it reads below an untraced window's rate."""

from __future__ import annotations


def read(ctx):
    return ctx.objects / ctx.host_s if ctx.calls else None
