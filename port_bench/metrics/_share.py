"""What the per-layer readers share."""

from __future__ import annotations

from .. import flops
from ..trace import OWN, function_name

FORWARDS = OWN["K1"] + OWN["K2"]     # the training tails' forwards are these kernels
# OWN[k][:2]: a kernel's bf16 and float32 main kernels, one launch each per call of its op


def per_call_ms(ctx, rows) -> float | None:
    """Device ms a call of `rows`, or None where there are none."""
    if not rows or not ctx.calls:
        return None
    return 1e3 * ctx.trace.seconds(rows) / ctx.calls


def roofline(ctx, kernel: str, bound_s: float, by_forward: bool = False) -> float | None:
    """Share (%) of the kernel's measured device time (its own kernels and
    the helpers given to it) that its bound takes: `bound_s` at the call's
    shapes for each launch of its own main kernel, or with `by_forward` for
    each forward launch (a training tail's forward and its backward's passes
    share one bound)."""
    rows = ctx.trace.of_kernel(kernel)
    if not rows:
        return None
    mains = FORWARDS if by_forward else OWN[kernel][:2]
    n = sum(1 for k in rows if function_name(k["name"]) in mains)
    return 100.0 * n * bound_s / ctx.trace.seconds(rows)


def clouds(ctx) -> int:
    """Clouds a launch of an encoder tail takes: both clouds of every slot."""
    return 2 * ctx.slots_per_call


def points(ctx) -> int:
    return ctx.cell.config["model"]["num_pcl"]


def mfu(ctx, passes: int) -> float | None:
    """Share (%) of the card's peak in the configuration's type that the
    model's work over the window takes: real objects x iterations x one
    object's forward operations (x passes)."""
    if not ctx.calls:
        return None
    dtype = ctx.cell.config["port"]["dtype"]
    work = ctx.objects * ctx.iterations * ctx.forward_flops * passes
    return 100.0 * work / (ctx.trace.window_s * flops.PEAK_FLOPS[dtype])


def reader_of(name: str):
    """The `read` of metric `name`'s reader, for the same quantity under
    another name in cells that report another end-to-end metric."""
    from ..harness import _reader
    return _reader(name).read
