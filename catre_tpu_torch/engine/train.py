"""Training step: per refine iteration a forward, a backward and an optimizer
step, with the pose fed back detached.

Counterpart of `catre_tpu/engine/train.py`: `InputNoiseConfig` (:26),
`TrainState` (:54), `_random_rotation` (:66), `_sample_init_pose` (:76),
`_sample_init_scale` (:116), `prepare_train_batch` (:147) and
`make_train_step` (:173, `with_vis` :175-254). The JAX package runs the inner
iterations as one jitted `lax.scan`; here they are a Python loop that updates
the model's parameters in place, and the metrics come back stacked over the
iterations as the scan stacks them. Under a profiler a step is the span
train.step, its augmentation and iteration-0 draws train.prepare, and each
iteration's forward + loss (the loss alone train.loss), backward, optimizer
step and metrics are train.forward, train.backward, train.optimizer and
train.metrics; the stacked metrics are train.metrics too. The step splits in two:
`prepare_train_batch` draws the augmentation and the init estimates from a
`torch.Generator`, and `TrainStep.step_on_prepared` is the deterministic
rest, so a test can hand it the batch the JAX package prepared.

The init estimate of iteration 0 (`engine_utils.py:187-247`) comes from one
mode of `init_pose_types` / `init_scale_types`, drawn per step when a list
holds several: gt_noise (normal noise around the gt), random (a rotation
uniform on SO(3) from a normalised Gaussian quaternion, a translation or
scale uniform in [min, max]), canonical (one fixed pose and size for every
object) or last_frame (`batch["last_frame_poses"]`, (B, 3, 5): R | t |
scale). JAX draws from `jax.random` keys, the port from the step's generator:
the same law and the same arithmetic, another stream. The order of draws on
the generator, each only where it applies: the 3D-box coin and its ratios,
the rigid-shift coin and its shift; then the pose: its mode's index (several
modes only), then gt_noise's std row, euler normals (B, 3), std row and
translation normals (B, 3), or random's quaternion normals (B, 4) and
translation uniforms (B, 3); then the scale: its mode's index (several modes
only), then gt_noise's std row and normals (B, 3), or random's uniforms
(B, 3). `_sample_init_pose` / `_sample_init_scale` take draws handed in
(`draws`), so a test drives both packages with the same numbers.

Over a process group of world W (`parallel/comm.py`) each process holds B of
the W x B rows of a global batch, rank r rows [r B, (r + 1) B), as JAX's
GSPMD step holds them on a mesh. Every process draws what the global batch
draws, from the same generator, and keeps its rows' draws
(`prepare_global_rows`); each loss term divides by its mask's count over the
group; the gradients are summed over the group, in one bucket, after the
backward and before the nan scrub, so clipping, Lookahead, LR_MULT and FREEZE
see the same gradients on every process; the metrics are summed once a step.
So W processes take world 1's step on the global batch, up to the order of
f32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..data.aug import aug_3d_bbox, aug_poses_normal, aug_rt, aug_scale_normal, maybe_apply
from ..geom.errors import rotation_error_deg, translation_error
from ..geom.rotations import quat_to_mat, rot_from_axangle_chain
from ..losses import LossConfig, catre_loss
from ..losses.catre_loss import loss_masks
from ..losses.common import masked_mean
from ..models.catre import CATREDisRShared, refine_forward
from ..parallel import comm
from ..solver.optimizer import PortOptimizer
from ..utils.profiler import span

INIT_MODES = ("gt_noise", "random", "canonical", "last_frame")


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
    # init estimate source of iteration 0 (`engine_utils.py:187-247`):
    # gt_noise | random | canonical | last_frame; one drawn per step
    init_pose_types: tuple = ("gt_noise",)
    init_scale_types: tuple = ("gt_noise",)
    random_trans_min: tuple = (-0.35, -0.35, 0.5)
    random_trans_max: tuple = (0.35, 0.35, 1.3)
    random_scale_min: tuple = (0.04, 0.04, 0.04)
    random_scale_max: tuple = (0.5, 0.3, 0.4)
    canonical_rot: tuple = ((1, 0, 0, 0.5), (0, 0, 1, -0.7))
    canonical_trans: tuple = (0.0, 0.0, 1.0)
    canonical_size: tuple = (0.2, 0.2, 0.2)


class TrainState(NamedTuple):
    """The step's optimizer and the parameters it updates in place: the step
    zeroes, scrubs and steps through these, and refuses a state whose
    parameters are not its model's (the forward runs that model) or whose
    optimizer is not the one it was built with."""

    params: dict              # name -> the model's parameter, updated in place
    optimizer: PortOptimizer
    step: int                 # outer step counter


def init_train_state(model: CATREDisRShared, optimizer: PortOptimizer) -> TrainState:
    return TrainState(dict(model.named_parameters()), optimizer, 0)


def _check_modes(kind: str, types, batch: dict) -> tuple:
    types = tuple(types)
    if not types or any(t not in INIT_MODES for t in types):
        raise ValueError(f"INIT_{kind.upper()}_TYPE_TRAIN = {types}: each must be one of "
                         f"{INIT_MODES}")
    if "last_frame" in types and "last_frame_poses" not in batch:
        raise ValueError(f"INIT_{kind.upper()}_TYPE_TRAIN {types} has last_frame, and the batch "
                         "has no last_frame_poses (B, 3, 5) (R | t | scale of the previous "
                         "frame)")
    return types


def _mode(generator, types: tuple, draws: dict, key: str) -> str:
    """One mode of `types`, drawn from the generator when there are several."""
    if len(types) == 1:
        return types[0]
    idx = draws[key] if key in draws else torch.randint(len(types), (), generator=generator)
    return types[int(idx)]


def _draw(generator, draws: dict, key: str, shape, like: torch.Tensor, normal: bool):
    if key in draws:
        value = draws[key]
    else:
        value = (torch.randn if normal else torch.rand)(shape, generator=generator)
    return torch.as_tensor(value, dtype=like.dtype).to(like.device)


def _random_rotation(generator, draws: dict, n: int, like: torch.Tensor) -> torch.Tensor:
    """n rotations uniform on SO(3): normalised Gaussian quaternions (n, 4),
    the law of `transform.random_rotation_matrix` (`catre_tpu/engine/train.py:66`)."""
    return quat_to_mat(_draw(generator, draws, "quat", (n, 4), like, normal=True))


def _sample_init_pose(generator, batch: dict, noise_cfg: InputNoiseConfig,
                      draws: dict | None = None) -> torch.Tensor:
    """obj_pose_est (B, 3, 4) of one mode of init_pose_types
    (`get_init_pose_train`, `engine_utils.py:216-247`). draws: "pose_mode",
    "quat" / "trans_uniform" (random)."""
    draws = draws or {}
    pose = batch["obj_pose"]
    n = pose.shape[0]
    mode = _mode(generator, _check_modes("pose", noise_cfg.init_pose_types, batch), draws,
                 "pose_mode")
    if mode == "gt_noise":
        return aug_poses_normal(generator, pose, noise_cfg.noise_rot_std,
                                noise_cfg.noise_trans_std, max_rot=noise_cfg.noise_rot_max,
                                min_z=noise_cfg.init_trans_min_z)
    if mode == "random":
        R = _random_rotation(generator, draws, n, pose)
        tmin = torch.tensor(noise_cfg.random_trans_min, dtype=pose.dtype, device=pose.device)
        tmax = torch.tensor(noise_cfg.random_trans_max, dtype=pose.dtype, device=pose.device)
        u = _draw(generator, draws, "trans_uniform", (n, 3), pose, normal=False)
        return torch.cat([R, (u * (tmax - tmin) + tmin)[:, :, None]], dim=-1)
    if mode == "canonical":
        R = rot_from_axangle_chain(noise_cfg.canonical_rot).to(pose.device, pose.dtype)
        t = torch.tensor(noise_cfg.canonical_trans, dtype=pose.dtype, device=pose.device)
        return torch.cat([R, t[:, None]], dim=-1)[None].expand(n, 3, 4).contiguous()
    return batch["last_frame_poses"][:, :3, :4].to(pose.dtype)


def _sample_init_scale(generator, batch: dict, noise_cfg: InputNoiseConfig,
                       draws: dict | None = None) -> torch.Tensor:
    """obj_scale_est (B, 3) of one mode of init_scale_types
    (`get_init_scale_train`, `engine_utils.py:187-213`). draws: "scale_mode",
    "scale_uniform" (random)."""
    draws = draws or {}
    scale = batch["obj_scale"]
    n = scale.shape[0]
    mode = _mode(generator, _check_modes("scale", noise_cfg.init_scale_types, batch), draws,
                 "scale_mode")
    if mode == "gt_noise":
        return aug_scale_normal(generator, scale, noise_cfg.noise_scale_std,
                                min_s=noise_cfg.init_scale_min, max_s=noise_cfg.init_scale_max)
    if mode == "random":
        smin = torch.tensor(noise_cfg.random_scale_min, dtype=scale.dtype, device=scale.device)
        smax = torch.tensor(noise_cfg.random_scale_max, dtype=scale.dtype, device=scale.device)
        return _draw(generator, draws, "scale_uniform", (n, 3), scale, normal=False) \
            * (smax - smin) + smin
    if mode == "canonical":
        size = torch.tensor(noise_cfg.canonical_size, dtype=scale.dtype, device=scale.device)
        return size[None].expand(n, 3).contiguous()
    return batch["last_frame_poses"][:, :3, 4].to(scale.dtype)


def prepare_train_batch(generator: torch.Generator, batch: dict,
                        noise_cfg: InputNoiseConfig) -> dict:
    """Batch augmentation (3D box rescale, then rigid shift, each on one coin
    per batch) and the iteration-0 estimates obj_pose_est / obj_scale_est of
    the init modes, around the (augmented) gt."""
    pcl, scale = maybe_apply(generator, noise_cfg.bbox3d_aug_prob, aug_3d_bbox,
                             (batch["pcl"], batch["obj_scale"]),
                             batch["pcl"], batch["obj_pose"], batch["obj_scale"],
                             batch["sym_flag"])
    pcl, pose = maybe_apply(generator, noise_cfg.rt_aug_prob, aug_rt, (pcl, batch["obj_pose"]),
                            pcl, batch["obj_pose"])
    batch = dict(batch, pcl=pcl, obj_pose=pose, obj_scale=scale)
    batch["obj_pose_est"] = _sample_init_pose(generator, batch, noise_cfg)
    batch["obj_scale_est"] = _sample_init_scale(generator, batch, noise_cfg)
    return batch


def prepare_global_rows(generator: torch.Generator, batch: dict, noise_cfg: InputNoiseConfig,
                        rank: int, world: int) -> dict:
    """`prepare_train_batch` for rank `rank`'s rows of a global batch of
    `world` equal shares: the draws of the whole global batch (each row's
    from its place in it), this rank's rows kept. The other ranks' places
    hold copies of these rows: every draw is per row or per batch, and no
    row's result reads another row."""
    if world == 1:
        return prepare_train_batch(generator, batch, noise_cfg)
    n = batch["pcl"].shape[0]
    tiled = {k: v.repeat(world, *([1] * (v.dim() - 1))) for k, v in batch.items()}
    prepared = prepare_train_batch(generator, tiled, noise_cfg)
    return {k: v[rank * n:(rank + 1) * n] for k, v in prepared.items()}


class TrainStep:
    """step(state, batch, generator, lr) -> (state, metrics): n_iter inner
    iterations of forward, `catre_loss`, backward, nan-scrubbed gradients and
    one optimizer step; each iteration starts from the previous one's
    pre-update prediction, detached. metrics: name -> (n_iter,) tensor; with
    `with_vis` also "_vis" (TRAIN.VIS_IMG): each iteration's predicted
    "pose" (n_iter, B, 3, 4) and "scale" (n_iter, B, 3), and the gt the loss
    saw ("gt_pose", "gt_scale"), "init_pose" and "valid". Over a process
    group the batch is this process's rows, every process gives the same
    generator and lr, and the metrics are the global batch's."""

    def __init__(self, model: CATREDisRShared, loss_cfg: LossConfig,
                 noise_cfg: InputNoiseConfig, optimizer: PortOptimizer, sym_bank: torch.Tensor,
                 n_iter: int, with_vis: bool = False):
        self.model, self.loss_cfg, self.noise_cfg = model, loss_cfg, noise_cfg
        self.optimizer, self.sym_bank, self.n_iter = optimizer, sym_bank, n_iter
        self.with_vis = with_vis

    def __call__(self, state: TrainState, batch: dict, generator: torch.Generator, lr: float):
        with span("train.step"):
            with span("train.prepare"):
                batch = prepare_global_rows(generator, batch, self.noise_cfg, comm.get_rank(),
                                            comm.get_world_size())
            return self.step_on_prepared(state, batch, lr)

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
        counts = self._group_counts(batch["sym_flag"], valid)
        gt_rot, gt_t = batch["obj_pose"][:, :3, :3], batch["obj_pose"][:, :3, 3]
        pose_est, scale_est = batch["obj_pose_est"], batch["obj_scale_est"]
        per_iter, vis = [], []
        for _ in range(self.n_iter):
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                pose, scale = refine_forward(self.model, batch["pcl"], batch["obj_kps"],
                                             pose_est, scale_est, batch["K"],
                                             batch.get("obj_mean_scales"))
                with span("train.loss"):
                    loss_dict = catre_loss(
                        self.loss_cfg, out_rot=pose[:, :3, :3], out_trans=pose[:, :3, 3],
                        out_scale=scale, gt_rot=gt_rot, gt_trans=gt_t,
                        gt_scale=batch["obj_scale"], obj_kps=batch["obj_kps"],
                        sym_flags=batch["sym_flag"], sym_bank=self.sym_bank, valid_mask=valid,
                        counts=counts)
                    total = sum(loss_dict.values())
            with span("train.backward"):
                total.backward()
                comm.all_reduce_grads_(params)
            with span("train.optimizer"):
                for p in params:
                    if p.grad is not None:
                        torch.nan_to_num(p.grad, out=p.grad)
                optimizer.step()
            with span("train.metrics"):
                pose_est, scale_est = pose.detach(), scale.detach()
                metrics = {k: v.detach() for k, v in loss_dict.items()}
                metrics["loss_total"] = total.detach()
                n_valid = counts.get("valid")
                metrics["error_R"] = masked_mean(rotation_error_deg(pose_est[:, :3, :3], gt_rot),
                                                 w, n_valid)
                metrics["error_t"] = masked_mean(translation_error(pose_est[:, :3, 3], gt_t), w,
                                                 n_valid)
                per_iter.append(metrics)
                if self.with_vis:
                    vis.append((pose_est, scale_est))
        with span("train.metrics"):
            stacked = {k: torch.stack([m[k] for m in per_iter]) for k in per_iter[0]}
            if counts:          # the processes' shares summed: the global batch's metrics
                names = list(stacked)
                summed = comm.all_reduce_(torch.stack([stacked[k] for k in names]))
                stacked = dict(zip(names, summed.unbind(0)))
        if self.with_vis:
            stacked["_vis"] = {
                "pose": torch.stack([v[0] for v in vis]), "scale": torch.stack([v[1] for v in vis]),
                "gt_pose": batch["obj_pose"], "gt_scale": batch["obj_scale"],
                "init_pose": batch["obj_pose_est"],
                "valid": valid if valid is not None else torch.ones(
                    batch["pcl"].shape[0], dtype=torch.bool, device=batch["pcl"].device)}
        return state._replace(step=state.step + 1), stacked

    @staticmethod
    def _group_counts(sym_flag: torch.Tensor, valid) -> dict:
        """The sums over the process group of the loss's masks
        (`losses.catre_loss.loss_masks`); {} at world 1. Refuses processes
        that hold different numbers of rows: the global batch's draws would
        not line up."""
        world = comm.get_world_size()
        if world == 1:
            return {}
        masks = loss_masks(sym_flag, valid)
        rows = sym_flag.shape[0]
        sums = comm.all_reduce_(torch.stack([m.sum() for m in masks.values()]
                                            + [masks["valid"].new_tensor(float(rows))]))
        if sums[-1].item() != world * rows:
            raise ValueError(f"the processes hold {int(sums[-1].item())} rows between them, not "
                             f"{world} x this one's {rows}: a global batch is split in equal "
                             "shares")
        return dict(zip(masks, sums[:-1].unbind(0)))


def make_train_step(model: CATREDisRShared, loss_cfg: LossConfig, noise_cfg: InputNoiseConfig,
                    optimizer: PortOptimizer, sym_bank, n_iter: int,
                    with_vis: bool = False) -> TrainStep:
    """The train step for a fixed number of refine iterations; with_vis adds
    the "_vis" payload (off by default: it keeps each iteration's per-object
    poses)."""
    bank = torch.as_tensor(sym_bank, dtype=torch.float32)
    device = next(model.parameters()).device
    return TrainStep(model, loss_cfg, noise_cfg, optimizer, bank.to(device), n_iter, with_vis)
