"""Learning-rate schedules: flat_and_anneal and detectron2's WarmupMultiStepLR
and WarmupCosineLR.

A copy of `catre_tpu/solver/schedule.py` (`flat_and_anneal_factor` :18,
`multistep_factor` :84, `warmup_cosine_factor` :101, `_warmup_wrap` :116,
`build_lr_fn` :134), pure Python (`math`, `bisect`), so the port's factors
are the JAX package's bit for bit. Behavioural reference:
`lib/torch_utils/solver/lr_scheduler.py:148-260`; the shipped config warms up
linearly over 1000 iterations from a factor of 1e-3, stays flat, then anneals
by a cosine from 0.72 of the total iterations (`configs/...120e.py:44-52`).

The value is the factor of the base lr at the OUTER iteration: the reference
steps its scheduler once an outer iteration, whatever the number of inner
optimizer steps (`engine.py:358`), and `TrainStep` sets the lr once a step.
"""

from __future__ import annotations

import math
from bisect import bisect_right


def flat_and_anneal_factor(
    x: float,
    total_iters: int,
    warmup_iters: int = 0,
    warmup_factor: float = 0.1,
    warmup_method: str = "linear",
    warmup_pow: float = 2.0,
    anneal_point: float = 0.72,
    anneal_method: str = "cosine",
    target_lr_factor: float = 0.0,
    poly_power: float = 1.0,
    step_gamma: float = 0.1,
    steps=(2.0 / 3.0, 8.0 / 9.0),
    cyclic: bool = False,
) -> float:
    """Pure python lr factor (used at trace time per outer iteration)."""
    if anneal_method == "step":
        anneal_start = steps[0] * total_iters
    else:
        anneal_start = anneal_point * total_iters

    x = x % total_iters if cyclic else x
    if x < warmup_iters:
        alpha = float(x) / warmup_iters
        if warmup_method == "linear":
            return (1 - warmup_factor) * alpha + warmup_factor
        if warmup_method == "pow":
            return (1 - warmup_factor) * pow(alpha, warmup_pow) + warmup_factor
        if warmup_method == "exp":
            return warmup_factor ** (1 - alpha)
        if warmup_method == "constant":
            return warmup_factor
        raise ValueError(warmup_method)

    if x < anneal_start:
        return 1.0
    if x < total_iters:
        if anneal_method == "step":
            milestones = [s * total_iters for s in steps]
            return step_gamma ** bisect_right(milestones, float(x))
        if anneal_method == "cosine":
            return target_lr_factor + 0.5 * (1 - target_lr_factor) * (
                1 + math.cos(math.pi * ((float(x) - anneal_start) / (total_iters - anneal_start)))
            )
        if anneal_method == "linear":
            return target_lr_factor + (1 - target_lr_factor) * (total_iters - float(x)) / (
                total_iters - anneal_start
            )
        if anneal_method == "poly":
            return target_lr_factor + (1 - target_lr_factor) * (
                (total_iters - float(x)) / (total_iters - anneal_start)
            ) ** poly_power
        if anneal_method == "exp":
            tgt = max(target_lr_factor, 5e-3)
            return tgt ** ((float(x) - anneal_start) / (total_iters - anneal_start))
        if anneal_method == "none":
            return 1.0
        raise ValueError(anneal_method)
    return target_lr_factor


# fvcore ParamScheduler.WHERE_EPSILON: interval/milestone checks tolerate
# float truncation at exact boundaries
_WHERE_EPSILON = 1e-6


def multistep_factor(x: float, total_iters: int, rel_steps=(2.0 / 3.0, 8.0 / 9.0),
                     gamma: float = 0.1, warmup_iters: int = 0,
                     warmup_factor: float = 0.001,
                     warmup_method: str = "linear") -> float:
    """d2 `WarmupMultiStepLR` (ref `core/utils/solver_utils.py:168-178`):
    fvcore MultiStepParamScheduler(values=[gamma^k], milestones=rel*total)
    wrapped in WarmupParamScheduler; evaluated at where = x/total."""
    milestones = [s * total_iters for s in rel_steps if s <= 1]

    def sched(where: float) -> float:
        epoch_num = int((where + _WHERE_EPSILON) * total_iters)
        return gamma ** bisect_right(milestones, epoch_num)

    return _warmup_wrap(sched, x / total_iters, warmup_iters / total_iters,
                        warmup_factor, warmup_method)


def warmup_cosine_factor(x: float, total_iters: int, warmup_iters: int = 0,
                         warmup_factor: float = 0.001,
                         warmup_method: str = "linear") -> float:
    """d2 `WarmupCosineLR` (ref `solver_utils.py:179-181`):
    CosineParamScheduler(1, 0) under the warmup wrapper."""
    def sched(where: float) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * where))

    return _warmup_wrap(sched, x / total_iters, warmup_iters / total_iters,
                        warmup_factor, warmup_method)


def _warmup_wrap(sched, where: float, warmup_length: float,
                 warmup_factor: float, warmup_method: str) -> float:
    """detectron2 WarmupParamScheduler == CompositeParamScheduler(
    [warmup, sched], lengths=[wl, 1-wl], scaling=[rescaled, fixed]): the
    warmup interval interpolates from warmup_factor*sched(0) to
    sched(warmup_length); the main interval evaluates sched at the GLOBAL
    where (fixed scaling)."""
    if warmup_length <= 0:
        return sched(where)
    end = sched(warmup_length)
    start = warmup_factor * sched(0.0)
    if (where + _WHERE_EPSILON) <= warmup_length:
        w = where / warmup_length  # "rescaled" interval scaling
        if warmup_method == "linear":
            return start + (end - start) * w
        if warmup_method == "constant":
            return start
        raise ValueError(f"Unknown warmup method: {warmup_method}")
    return sched(where)


def build_lr_fn(cfg: dict, total_iters: int):
    """Build a step -> lr function from a SOLVER config dict.

    Mirrors `core/utils/solver_utils.py:134-190` (build_lr_scheduler):
    flat_and_anneal plus the detectron2 fallbacks WarmupMultiStepLR and
    WarmupCosineLR (evaluated as d2's LRMultiplier does: factor at
    where = iteration / total_iters).
    """
    base_lr = float(cfg.get("BASE_LR", cfg.get("OPTIMIZER_CFG", {}).get("lr", 1e-4)))
    name = cfg.get("LR_SCHEDULER_NAME", "flat_and_anneal")
    if name == "WarmupMultiStepLR":
        def lr_fn(step: int) -> float:
            return base_lr * multistep_factor(
                step, total_iters,
                rel_steps=cfg.get("REL_STEPS", (2.0 / 3.0, 8.0 / 9.0)),
                gamma=float(cfg.get("GAMMA", 0.1)),
                warmup_iters=int(cfg.get("WARMUP_ITERS", 1000)),
                warmup_factor=float(cfg.get("WARMUP_FACTOR", 0.001)),
                warmup_method=cfg.get("WARMUP_METHOD", "linear"),
            )

        return lr_fn
    if name == "WarmupCosineLR":
        def lr_fn(step: int) -> float:
            return base_lr * warmup_cosine_factor(
                step, total_iters,
                warmup_iters=int(cfg.get("WARMUP_ITERS", 1000)),
                warmup_factor=float(cfg.get("WARMUP_FACTOR", 0.001)),
                warmup_method=cfg.get("WARMUP_METHOD", "linear"),
            )

        return lr_fn
    if name != "flat_and_anneal":
        raise ValueError(f"Unknown LR scheduler: {name}")
    warmup_iters = int(cfg.get("WARMUP_ITERS", 1000))
    warmup_factor = float(cfg.get("WARMUP_FACTOR", 0.001))
    warmup_method = cfg.get("WARMUP_METHOD", "linear")
    anneal_method = cfg.get("ANNEAL_METHOD", "cosine")
    anneal_point = float(cfg.get("ANNEAL_POINT", 0.72))
    target_lr_factor = float(cfg.get("TARGET_LR_FACTOR", 0.0))
    poly_power = float(cfg.get("POLY_POWER", 1.0))
    step_gamma = float(cfg.get("GAMMA", 0.1))
    rel_steps = cfg.get("REL_STEPS", (2.0 / 3.0, 8.0 / 9.0))

    def lr_fn(step: int) -> float:
        return base_lr * flat_and_anneal_factor(
            step,
            total_iters=total_iters,
            warmup_iters=warmup_iters,
            warmup_factor=warmup_factor,
            warmup_method=warmup_method,
            anneal_point=anneal_point,
            anneal_method=anneal_method,
            target_lr_factor=target_lr_factor,
            poly_power=poly_power,
            step_gamma=step_gamma,
            steps=rel_steps,
        )

    return lr_fn
