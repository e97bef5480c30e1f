"""`host_obj_per_s.train` in the test cell: real objects refined a second
of the traced window on the host's clock."""

from __future__ import annotations

from ._share import reader_of

read = reader_of("host_obj_per_s.train")
