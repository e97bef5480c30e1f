"""`optimizer_ms.train` in the float32 cells, where it moves `train_obj_per_s`."""

from __future__ import annotations

from ._share import reader_of

read = reader_of("optimizer_ms.train")
