"""The refine's share (%) of the card's peak: real objects x iterations x
an object's forward operations over the window."""

from __future__ import annotations

from ._share import mfu


def read(ctx):
    return mfu(ctx, 1)
