"""Device ms a step of the kernels and copies launched under the port's
`train.optimizer` range (the NaN scrub and Ranger)."""

from __future__ import annotations

from ._share import per_call_ms


def read(ctx):
    t = ctx.trace
    return per_call_ms(ctx, t.launched_under(t.kernels + t.copies, "train.optimizer"))
