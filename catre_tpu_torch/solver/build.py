"""Optimizer from the SOLVER config.

Counterpart of the Ranger part of `catre_tpu/solver/build.py`
(`_base_optimizer` :18, `build_optimizer` :159). Only `type="Ranger"` is
ported; the learning-rate schedule (`solver/schedule.py`) waits for the
runner, and the train step takes `lr` as an argument, as the JAX one does.
Gradient clipping, per-head learning-rate multipliers and frozen
sub-networks are not ported either: a config that asks for one raises.
"""

from __future__ import annotations

from .ranger import Ranger

_LATER = "ROADMAP.md items 11 + 12a"


def refuse_unported_training_keys(cfg) -> None:
    """Raise for the keys of a whole config that change how the JAX package
    trains and that the port does not apply yet: a per-head learning-rate
    multiplier other than 1 and a frozen sub-network, which
    `catre_tpu/engine/runner.py` (:197-205) hands to its optimizer as
    `lr_mults` and `frozen`. Called before the optimizer is built, so that
    such a config does not train differently without a word."""
    net = cfg.MODEL.CATRE
    for head in ("ROT_HEAD", "TS_HEAD"):
        mult = float(net[head].get("LR_MULT", 1.0))
        if mult != 1.0:
            raise NotImplementedError(
                f"MODEL.CATRE.{head}.LR_MULT = {mult}: the port trains every parameter at "
                f"the base learning rate; per-head multipliers are {_LATER}")
    for sub in ("PCLNET", "ROT_HEAD", "TS_HEAD"):
        if net[sub].get("FREEZE", False):
            raise NotImplementedError(
                f"MODEL.CATRE.{sub}.FREEZE is set: the port freezes nothing; frozen "
                f"sub-networks are {_LATER}")


def build_optimizer(solver_cfg: dict, named_params) -> Ranger:
    """Ranger over `named_params` ((name, parameter) pairs, e.g.
    `model.named_parameters()`) from SOLVER.OPTIMIZER_CFG."""
    if solver_cfg.get("CLIP_GRADIENTS", {}).get("ENABLED", False):
        raise NotImplementedError(
            "SOLVER.CLIP_GRADIENTS.ENABLED is set: the port does not clip gradients "
            f"(`catre_tpu/solver/build.py` :197-204 does); gradient clipping is {_LATER}")
    opt_cfg = dict(solver_cfg.get("OPTIMIZER_CFG", {"type": "Ranger", "lr": 1e-4}))
    typ = str(opt_cfg.get("type", "Ranger"))
    if typ.lower() != "ranger":
        raise NotImplementedError(
            f"optimizer type {typ}: the port has Ranger only; the rest of the registry is "
            "ROADMAP.md item 11")
    betas = opt_cfg.get("betas", (0.95, 0.999))
    return Ranger(
        named_params, lr=float(opt_cfg.get("lr", 1e-4)),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
        betas=(float(betas[0]), float(betas[1])), eps=float(opt_cfg.get("eps", 1e-5)),
        k=int(opt_cfg.get("k", 6)), alpha=float(opt_cfg.get("alpha", 0.5)),
        use_gc=bool(opt_cfg.get("use_gc", True)))
