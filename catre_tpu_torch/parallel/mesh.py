"""Batch padding for an even split over processes.

Counterpart of `catre_tpu/parallel/mesh.py::pad_to_multiple` (:80). The rest
of that module has no counterpart here (ROADMAP item 15): `make_mesh`,
`batch_sharding`, `replicated`, `shard_batch`, `replicate_tree` and
`make_global_batch` (:27-78) build one program over a mesh of devices, where
the port runs one process per card (`parallel/launch.py`). Each process holds
its rows of the global batch, the parameters are the same on every process,
and the train step sums the gradients and the masks' counts over the group
(`engine/train.py`) where GSPMD's psums do it in JAX.
"""

from __future__ import annotations

import numpy as np


def pad_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the leading axis of every array to a multiple (for an even split),
    extending the 'valid' mask with False and repeating the last row
    elsewhere."""
    n = next(iter(batch.values())).shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return batch
    pad = target - n
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if k == "valid":
            out[k] = np.concatenate([v, np.zeros(pad, dtype=bool)])
        else:
            widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(v, widths, mode="edge" if v.ndim else "constant")
    return out
