"""Device ms a step of the forward's and backward's kernels not built from
the port's sources (launched under the port's `train.forward` and
`train.backward` ranges)."""

from __future__ import annotations

from ._share import per_call_ms


def read(ctx):
    t = ctx.trace
    return per_call_ms(ctx, t.launched_under(t.plain(), "train.forward", "train.backward"))
