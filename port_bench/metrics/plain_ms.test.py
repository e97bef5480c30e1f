"""Device ms a call of the refine's kernels not built from the port's
sources: library products, bias adds, activations, norms, casts (launched
under `bench.refine`)."""

from __future__ import annotations

from ._share import per_call_ms


def read(ctx):
    t = ctx.trace
    return per_call_ms(ctx, t.launched_under(t.plain(), "bench.refine"))
