"""`idle_share.test` in the float32 cells, where it moves `refine_obj_per_s`."""

from __future__ import annotations

from ._share import reader_of

read = reader_of("idle_share.test")
