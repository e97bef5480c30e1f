"""Iterative refinement (inference path).

Counterpart of `catre_tpu/engine/refiner.py::make_refine_fn` (:21). The JAX
package runs the iterations as one jitted `lax.scan`; here they are a Python
loop under `torch.inference_mode`, each iteration feeding the next.
"""

from __future__ import annotations

import torch

from ..models.catre import CATREDisRShared, refine_forward


def make_refine_fn(model: CATREDisRShared, n_iter: int):
    """Build refine(pcl, obj_kps, init_pose, init_scale, K, mean_scales) ->
    (poses (n_iter+1, B, 3, 4), scales (n_iter+1, B, 3)); index 0 holds the
    initial estimates."""

    @torch.inference_mode()
    def refine(pcl, obj_kps, init_pose, init_scale, K, mean_scales=None):
        poses, scales = [init_pose], [init_scale]
        for _ in range(n_iter):
            pose, scale = refine_forward(model, pcl, obj_kps, poses[-1], scales[-1], K,
                                         mean_scales)
            poses.append(pose)
            scales.append(scale)
        return torch.stack(poses), torch.stack(scales)

    return refine
