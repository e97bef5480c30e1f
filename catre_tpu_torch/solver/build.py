"""Optimizer from the SOLVER config.

Counterpart of the Ranger part of `catre_tpu/solver/build.py`
(`_base_optimizer` :18, `build_optimizer` :159). Only `type="Ranger"` is
ported; the learning-rate schedule (`solver/schedule.py`) waits for the
runner, and the train step takes `lr` as an argument, as the JAX one does.
"""

from __future__ import annotations

from .ranger import Ranger


def build_optimizer(solver_cfg: dict, named_params) -> Ranger:
    """Ranger over `named_params` ((name, parameter) pairs, e.g.
    `model.named_parameters()`) from SOLVER.OPTIMIZER_CFG."""
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
