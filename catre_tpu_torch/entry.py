"""Entry points: the flagship 4-iteration refine and the flagship training
step, built from the shipped production config.

Counterpart of `__graft_entry__.py` (`entry` :83, `_flagship` :6,
`_example_batch` :21, `_near_identity_params` :44). The model configuration
comes from `catre_tpu/configs/nocs_real/..._120e_tpu.py` (bf16, fused rot
head, fused encoder tails, FUSED_HEADS_TRAIN, FUSED_ENCODER_TRAIN) read
through the port's own loader; the weights are random, from a seed.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .config.build import (FLAGSHIP_CONFIG, loss_config_from, model_config_from,
                           noise_config_from)
from .config.loader import load_config
from .engine.refiner import make_refine_fn
from .engine.train import TrainState, TrainStep, init_train_state, make_train_step
from .geom.rotations import euler_to_mat
from .geom.symmetry import axis_symmetry_rotation_bank
from .models.catre import CATREConfig, CATREDisRShared, init_model
from .solver.build import build_optimizer, refuse_unported_training_keys

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


def entry(device="cuda", batch_size: int = 8, seed: int = 0, **overrides):
    """(fn, example_args): the flagship 4-iteration refine (1024 observed
    points + 1024 prior keypoints) on `device`; fn(*example_args) returns
    (poses (5, B, 3, 4), scales (5, B, 3)). `overrides` replace fields of
    the model's `CATREConfig`: `fused_encoder=True` runs the encoder columns
    through K9, `fused_block_size=4` the rot head through K8."""
    cfg = flagship_config(**overrides)
    model = init_model(cfg, seed=seed, device=device)
    refine = make_refine_fn(model, n_iter=N_ITER)
    b = example_batch(batch_size, cfg.num_pcl, cfg.num_kps, device=device, seed=seed)
    args = (b["pcl"], b["obj_kps"], b["obj_pose"], b["obj_scale"], b["K"], b["obj_mean_scales"])
    return refine, args


def train_batch(b: int, num_pcl: int, num_kps: int, device="cpu", seed: int = 0) -> dict:
    """Synthetic training batch (numpy, from `seed`), as
    `tests/test_engine.py::_synthetic_batch`: an anisotropically scaled
    canonical shape (the keypoints) posed in the camera frame (the cloud),
    every third object y-symmetric, all rows valid."""
    rng = np.random.default_rng(seed)
    canonical = rng.normal(size=(b, max(num_pcl, num_kps), 3)).astype(np.float32)
    canonical /= np.abs(canonical).max(axis=(1, 2), keepdims=True) * 2
    scale = rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32)
    euler = rng.uniform(-np.pi, np.pi, size=(b, 3)).astype(np.float32)
    R = euler_to_mat(torch.from_numpy(euler)).numpy()
    t = np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                  rng.uniform(0.6, 1.2, b)], axis=1).astype(np.float32)
    pcl = np.einsum("bij,bpj->bpi", R, canonical[:, :num_pcl] * scale[:, None, :]) + t[:, None]
    K = np.tile(np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]], np.float32),
                (b, 1, 1))
    arrays = {
        "pcl": pcl.astype(np.float32), "obj_kps": canonical[:, :num_kps],
        "obj_pose": np.concatenate([R, t[:, :, None]], axis=2).astype(np.float32),
        "obj_scale": scale, "obj_mean_scales": scale, "K": K,
        "sym_flag": np.arange(b) % 3 == 0, "valid": np.ones(b, dtype=bool),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


@dataclasses.dataclass
class Trainer:
    """Everything one flagship training step needs."""

    step: TrainStep
    state: TrainState
    batch: dict
    generator: torch.Generator
    lr: float


def flagship_trainer(device="cuda", batch_size: int = 512, seed: int = 0,
                     **model_overrides) -> Trainer:
    """The shipped config's training set-up (rot head K3/K4, encoder tails
    K5/K6): a seeded model on `device`, Ranger at the shipped lr, the train
    step at N_ITER_TRAIN inner iterations and a synthetic batch.
    `model_overrides` replace fields of the model's `CATREConfig`, e.g.
    `fused_encoder_train=False` for the plain encoder under autograd."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    refuse_unported_training_keys(cfg)
    mcfg = dataclasses.replace(model_config_from(cfg), **model_overrides)
    model = init_model(mcfg, seed=seed, device=device)
    optimizer = build_optimizer(cfg.SOLVER, model.named_parameters())
    sym_bank = axis_symmetry_rotation_bank(
        max_sym_disc_step=float(cfg.INPUT.get("MAX_SYM_DISC_STEP", 0.01)))
    step = make_train_step(model, loss_config_from(cfg), noise_config_from(cfg), optimizer,
                           sym_bank, n_iter=int(cfg.MODEL.CATRE.N_ITER_TRAIN))
    return Trainer(step, init_train_state(model, optimizer),
                   train_batch(batch_size, mcfg.num_pcl, mcfg.num_kps, device=device, seed=seed),
                   torch.Generator().manual_seed(seed), optimizer.param_groups[0]["lr"])


def train_entry(device="cuda", batch_size: int = 512, steps: int = 3, seed: int = 0,
                callback=None, **model_overrides):
    """`steps` flagship training steps (N_ITER_TRAIN = 4 inner iterations
    each) on `device`; `callback(i, metrics)` runs after step i. Returns
    (state, [metrics of each step]); the state names the trained parameters."""
    t = flagship_trainer(device, batch_size, seed, **model_overrides)
    history = []
    for i in range(steps):
        t.state, metrics = t.step(t.state, t.batch, t.generator, t.lr)
        history.append(metrics)
        if callback is not None:
            callback(i, metrics)
    return t.state, history
