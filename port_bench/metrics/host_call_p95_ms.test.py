"""95th percentile of the traced window's calls' latency on the host's
clock, ms: a group handed over to its poses and scales on the host. Read
under the profiler, which slows the host."""

from __future__ import annotations

from ..harness import percentile


def read(ctx):
    return 1e3 * percentile(ctx.latencies, 95) if ctx.latencies else None
