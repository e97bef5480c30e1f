"""Share (%) of the traced window in which no kernel or copy ran."""

from __future__ import annotations


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
