"""Entry point: the flagship 4-iteration refine, built from the shipped
production config.

Counterpart of `__graft_entry__.py` (`entry` :83, `_flagship` :6,
`_example_batch` :21, `_near_identity_params` :44). The model configuration
comes from `catre_tpu/configs/nocs_real/..._120e_tpu.py` (bf16, fused rot
head, fused encoder tails) read through the port's own loader; the weights
are random, from a seed.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .config.build import FLAGSHIP_CONFIG, model_config_from
from .config.loader import load_config
from .engine.refiner import make_refine_fn
from .models.catre import CATREConfig, CATREDisRShared, init_model

N_ITER = 4


def flagship_config(**overrides) -> CATREConfig:
    """`CATREConfig` of the shipped production config, with field overrides."""
    cfg = model_config_from(load_config(str(FLAGSHIP_CONFIG)))
    return dataclasses.replace(cfg, **overrides)


def example_batch(b: int, num_pcl: int, num_kps: int, device="cpu", seed: int = 0) -> dict:
    """Synthetic refine inputs (made with numpy from `seed`): identity init
    rotation at 1 m, clouds around it, NOCS-REAL intrinsics."""
    rng = np.random.default_rng(seed)
    R = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    t = np.tile(np.array([0.0, 0.0, 1.0], dtype=np.float32), (b, 1))
    K = np.tile(np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    arrays = {
        "pcl": rng.normal(size=(b, num_pcl, 3)).astype(np.float32) * 0.1 + t[:, None, :],
        "obj_kps": rng.normal(size=(b, num_kps, 3)).astype(np.float32) * 0.3,
        "obj_pose": np.concatenate([R, t[:, :, None]], axis=2),
        "obj_scale": rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32),
        "obj_mean_scales": rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32),
        "K": K,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def near_identity_model(model: CATREDisRShared) -> CATREDisRShared:
    """Copy of `model` whose head output layers are canned so that every
    refine iteration predicts the exact identity delta for the shipped
    composition (image-space cosypose translation, iter_add scale, ego
    rot6d): rot6d = (1,0,0),(0,1,0); trans = (0,0,1); scale delta = 0.
    With init == gt the refined poses and scales must equal the init."""
    m = copy.deepcopy(model)
    with torch.no_grad():
        for head, bias in ((m.rot_head.rot_head_x, (1.0, 0.0, 0.0)),
                           (m.rot_head.rot_head_y, (0.0, 1.0, 0.0))):
            head.neck.weight.zero_()
            head.neck.bias.copy_(torch.tensor(bias))
            head.point_bias.zero_()
            head.point_weight.zero_()
            head.point_weight[0] = 1.0   # the neck bias passes through once
        m.ts_head.fc_t.weight.zero_()
        m.ts_head.fc_t.bias.copy_(torch.tensor([0.0, 0.0, 1.0]))
        m.ts_head.fc_s.weight.zero_()
        m.ts_head.fc_s.bias.zero_()
    return m


def entry(device="cuda", batch_size: int = 8, seed: int = 0):
    """(fn, example_args): the flagship 4-iteration refine (1024 observed
    points + 1024 prior keypoints) on `device`; fn(*example_args) returns
    (poses (5, B, 3, 4), scales (5, B, 3))."""
    cfg = flagship_config()
    model = init_model(cfg, seed=seed, device=device)
    refine = make_refine_fn(model, n_iter=N_ITER)
    b = example_batch(batch_size, cfg.num_pcl, cfg.num_kps, device=device, seed=seed)
    args = (b["pcl"], b["obj_kps"], b["obj_pose"], b["obj_scale"], b["K"], b["obj_mean_scales"])
    return refine, args
