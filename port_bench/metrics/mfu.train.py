"""The train step's share (%) of the card's peak: rows x inner iterations
x an object's forward and backward operations (3 x forward) over the
window."""

from __future__ import annotations

from ._share import mfu


def read(ctx):
    return mfu(ctx, 3)
