"""Training step: per refine iteration a forward, a backward and a Ranger
step, with the pose fed back detached.

Counterpart of `catre_tpu/engine/train.py`: `InputNoiseConfig` (:26),
`TrainState` (:54), `prepare_train_batch` (:147) and `make_train_step`
(:173). The JAX package runs the inner iterations as one jitted `lax.scan`;
here they are a Python loop that updates the model's parameters in place,
and the metrics come back stacked over the iterations as the scan stacks
them. Each iteration's forward + loss, backward and optimizer step are
`torch.profiler` ranges (train.forward, train.backward, train.optimizer).
The step splits in two: `prepare_train_batch` draws the augmentation and the
init noise from a `torch.Generator`, and `TrainStep.step_on_prepared` is the
deterministic rest, so a test can hand it the batch the JAX package
prepared.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..data.aug import aug_3d_bbox, aug_poses_normal, aug_rt, aug_scale_normal, maybe_apply
from ..geom.errors import rotation_error_deg, translation_error
from ..losses import LossConfig, catre_loss
from ..losses.common import masked_mean
from ..models.catre import CATREDisRShared, refine_forward
from ..solver.ranger import Ranger


@dataclass(frozen=True)
class InputNoiseConfig:
    """Train-time init-pose/scale noise and batch augmentation (INPUT.* of
    the shipped config, `configs/...120e.py:5-36`)."""

    noise_rot_std: tuple = (10.0, 5.0, 2.5, 1.25)
    noise_trans_std: tuple = ((0.02, 0.02, 0.02), (0.01, 0.01, 0.01), (0.005, 0.005, 0.005))
    noise_scale_std: tuple = ((0.01, 0.01, 0.01), (0.005, 0.005, 0.005), (0.002, 0.002, 0.002))
    noise_rot_max: float = 45.0
    init_trans_min_z: float = 0.1
    init_scale_min: float = 0.04
    init_scale_max: float = 0.45
    bbox3d_aug_prob: float = 0.5
    rt_aug_prob: float = 0.5
    # init estimate source of iteration 0; the port has gt_noise, the mode
    # the shipped config uses (`120e.py:12`)
    init_pose_types: tuple = ("gt_noise",)
    init_scale_types: tuple = ("gt_noise",)


class TrainState(NamedTuple):
    """The step's optimizer and the parameters it updates in place: the step
    zeroes, scrubs and steps through these, and refuses a state whose
    parameters are not its model's (the forward runs that model) or whose
    optimizer is not the one it was built with."""

    params: dict              # name -> the model's parameter, updated in place
    optimizer: Ranger
    step: int                 # outer step counter


def init_train_state(model: CATREDisRShared, optimizer: Ranger) -> TrainState:
    return TrainState(dict(model.named_parameters()), optimizer, 0)


def prepare_train_batch(generator: torch.Generator, batch: dict,
                        noise_cfg: InputNoiseConfig) -> dict:
    """Batch augmentation (3D box rescale, then rigid shift, each on one coin
    per batch) and the iteration-0 estimates obj_pose_est / obj_scale_est
    drawn around the (augmented) gt."""
    for kind, types in (("pose", noise_cfg.init_pose_types),
                        ("scale", noise_cfg.init_scale_types)):
        if tuple(types) != ("gt_noise",):
            raise NotImplementedError(
                f"init {kind} types {tuple(types)}: the port has gt_noise only; random, "
                "canonical and last_frame are ROADMAP.md item 12")
    pcl, scale = maybe_apply(generator, noise_cfg.bbox3d_aug_prob, aug_3d_bbox,
                             (batch["pcl"], batch["obj_scale"]),
                             batch["pcl"], batch["obj_pose"], batch["obj_scale"],
                             batch["sym_flag"])
    pcl, pose = maybe_apply(generator, noise_cfg.rt_aug_prob, aug_rt, (pcl, batch["obj_pose"]),
                            pcl, batch["obj_pose"])
    batch = dict(batch, pcl=pcl, obj_pose=pose, obj_scale=scale)
    batch["obj_pose_est"] = aug_poses_normal(
        generator, pose, noise_cfg.noise_rot_std, noise_cfg.noise_trans_std,
        max_rot=noise_cfg.noise_rot_max, min_z=noise_cfg.init_trans_min_z)
    batch["obj_scale_est"] = aug_scale_normal(
        generator, scale, noise_cfg.noise_scale_std, min_s=noise_cfg.init_scale_min,
        max_s=noise_cfg.init_scale_max)
    return batch


class TrainStep:
    """step(state, batch, generator, lr) -> (state, metrics): n_iter inner
    iterations of forward, `catre_loss`, backward, nan-scrubbed gradients and
    one optimizer step; each iteration starts from the previous one's
    pre-update prediction, detached. metrics: name -> (n_iter,) tensor."""

    def __init__(self, model: CATREDisRShared, loss_cfg: LossConfig,
                 noise_cfg: InputNoiseConfig, optimizer: Ranger, sym_bank: torch.Tensor,
                 n_iter: int):
        self.model, self.loss_cfg, self.noise_cfg = model, loss_cfg, noise_cfg
        self.optimizer, self.sym_bank, self.n_iter = optimizer, sym_bank, n_iter

    def __call__(self, state: TrainState, batch: dict, generator: torch.Generator, lr: float):
        return self.step_on_prepared(state, prepare_train_batch(generator, batch, self.noise_cfg),
                                     lr)

    def step_on_prepared(self, state: TrainState, batch: dict, lr: float):
        cfg = self.model.cfg
        model_params = dict(self.model.named_parameters())
        if (state.params.keys() != model_params.keys()
                or any(state.params[n] is not p for n, p in model_params.items())):
            raise ValueError("train state: its parameters are not the step's model's")
        if state.optimizer is not self.optimizer:
            raise ValueError("train state: its optimizer is not the one the step was built with")
        optimizer, params = state.optimizer, list(state.params.values())
        batch = dict(batch)
        if not cfg.refine_scale:
            # REFINE_SCLAE=False: the estimate is the unperturbed gt scale
            batch["obj_scale_est"] = batch["obj_scale"]
        if "obj_fps_points" in batch:
            # KPS_TYPE="fps": normalised once by the iteration-0 scale estimate
            batch["obj_kps"] = batch["obj_fps_points"] / batch["obj_scale_est"][:, None, :]
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        valid = batch.get("valid")
        w = None if valid is None else valid.float()
        gt_rot, gt_t = batch["obj_pose"][:, :3, :3], batch["obj_pose"][:, :3, 3]
        pose_est, scale_est = batch["obj_pose_est"], batch["obj_scale_est"]
        per_iter = []
        for _ in range(self.n_iter):
            optimizer.zero_grad(set_to_none=True)
            with record_function("train.forward"):
                pose, scale = refine_forward(self.model, batch["pcl"], batch["obj_kps"],
                                             pose_est, scale_est, batch["K"],
                                             batch.get("obj_mean_scales"))
                loss_dict = catre_loss(
                    self.loss_cfg, out_rot=pose[:, :3, :3], out_trans=pose[:, :3, 3],
                    out_scale=scale, gt_rot=gt_rot, gt_trans=gt_t, gt_scale=batch["obj_scale"],
                    obj_kps=batch["obj_kps"], sym_flags=batch["sym_flag"],
                    sym_bank=self.sym_bank, valid_mask=valid)
                total = sum(loss_dict.values())
            with record_function("train.backward"):
                total.backward()
            with record_function("train.optimizer"):
                for p in params:
                    if p.grad is not None:
                        torch.nan_to_num(p.grad, out=p.grad)
                optimizer.step()
            pose_est, scale_est = pose.detach(), scale.detach()
            metrics = {k: v.detach() for k, v in loss_dict.items()}
            metrics["loss_total"] = total.detach()
            metrics["error_R"] = masked_mean(rotation_error_deg(pose_est[:, :3, :3], gt_rot), w)
            metrics["error_t"] = masked_mean(translation_error(pose_est[:, :3, 3], gt_t), w)
            per_iter.append(metrics)
        stacked = {k: torch.stack([m[k] for m in per_iter]) for k in per_iter[0]}
        return state._replace(step=state.step + 1), stacked


def make_train_step(model: CATREDisRShared, loss_cfg: LossConfig, noise_cfg: InputNoiseConfig,
                    optimizer: Ranger, sym_bank, n_iter: int) -> TrainStep:
    """The train step for a fixed number of refine iterations."""
    bank = torch.as_tensor(sym_bank, dtype=torch.float32)
    device = next(model.parameters()).device
    return TrainStep(model, loss_cfg, noise_cfg, optimizer, bank.to(device), n_iter)
