"""Prior keypoint selection (INPUT.KPS_TYPE).

Counterpart of `catre_tpu/data/kps.py`: `normed_bbox_corners` (:15),
`normed_axis_points` (:32) and `select_kps` (:47), for the types
`mean_shape`, `fps`, `bbox` and `axis`. The shipped config uses
KPS_TYPE="mean_shape" with 1024-point category mean shapes.
"""

from __future__ import annotations

import numpy as np
import torch


def normed_bbox_corners() -> np.ndarray:
    """The unit cube's 8 corners in the reference's order."""
    return np.array(
        [
            [0.5, 0.5, 0.5],
            [-0.5, 0.5, 0.5],
            [-0.5, -0.5, 0.5],
            [0.5, -0.5, 0.5],
            [0.5, 0.5, -0.5],
            [-0.5, 0.5, -0.5],
            [-0.5, -0.5, -0.5],
            [0.5, -0.5, -0.5],
        ],
        dtype=np.float32,
    )


def normed_axis_points(num_kps: int = 4, with_neg: bool = False) -> np.ndarray:
    """Axis keypoints: points along each axis plus the origin."""
    num_per_axis = (num_kps - 1) // 3
    start, length = (-0.5, 1.0) if with_neg else (0.0, 0.5)
    pts = []
    for axis in range(3):
        for i in range(1, num_per_axis + 1):
            p = [0.0, 0.0, 0.0]
            p[axis] = start + length * i / num_per_axis
            pts.append(p)
    pts.append([0.0, 0.0, 0.0])
    return np.array(pts, dtype=np.float32)


def select_kps(kps_type: str, mean_points=None, scale_est=None, fps_points=None,
               num_kps: int = 1024, with_neg_axis: bool = False):
    """(B, K, 3) normalized prior keypoints per KPS_TYPE.

    Numpy in gives numpy out; a tensor in gives a tensor out, on the same
    device (the bbox and axis tables are broadcast views of a tiny table)."""
    kt = kps_type.lower()
    if kt == "mean_shape":
        assert mean_points is not None
        return mean_points
    if kt == "fps":
        assert fps_points is not None and scale_est is not None
        return fps_points / scale_est[:, None, :]
    assert scale_est is not None
    b = scale_est.shape[0]
    if kt == "bbox":
        table = normed_bbox_corners()
    elif kt == "axis":
        table = normed_axis_points(num_kps, with_neg_axis)
    else:
        raise NotImplementedError(f"Unknown keypoints type {kps_type}")
    if torch.is_tensor(scale_est):
        return torch.from_numpy(table).to(scale_est.device)[None].expand(b, *table.shape)
    return np.broadcast_to(table[None], (b,) + table.shape)
