"""Optimizer from the SOLVER config: the whole registry, gradient clipping,
LR_MULT and FREEZE.

Counterpart of `catre_tpu/solver/build.py`: `_base_optimizer` (:18-156),
with the same type names, aliases, per-type defaults and error, and
`build_optimizer` (:159-205); `optimizer_from_config` derives `lr_mults` and
`frozen` from the MODEL section as `catre_tpu/engine/runner.py::do_train`
(:196-206) does. Every type but Ranger is a `TreeOptimizer` over a transform
(`transforms`, `extra`, `ranger_family`). Lookahead is one mechanism, the
layers of `PortOptimizer`: Ranger, over9000 / rangerlars, ranger2020,
ranger_adabelief and ranger21 get their own (k, alpha) as the first layer,
and `lookahead` adds one to any inner type. `optimizer.PortOptimizer` applies the clipping, the
Lookahead layers and the multipliers in JAX's order. The learning rate is
read from `param_groups` at every step (`TrainStep` sets it each step from
`schedule.build_lr_fn`).
"""

from __future__ import annotations

from . import extra, ranger_family, transforms
from .optimizer import CLIP_TYPES, PortOptimizer, TreeOptimizer
from .ranger import Ranger


OPTIMIZER_TYPES = ("ranger", "adam", "adamw", "sgd", "radam", "adabelief", "nadam", "nadamw",
                   "rmsprop", "rmsprop_tf", "lamb", "lars", "ralamb", "over9000", "rangerlars",
                   "madgrad", "adamp", "sgdp", "sgd_gc", "sgd_gcc", "ranger2020",
                   "rangeradabelief", "ranger_adabelief", "badam", "ranger21", "lookahead")


def _betas(opt_cfg: dict, default) -> tuple:
    b = opt_cfg.get("betas", default)
    return float(b[0]), float(b[1])


def _base_optimizer(opt_cfg: dict) -> tuple:
    """-> (make(named_params, lr, lookaheads) -> PortOptimizer, base lr)."""
    typ = str(opt_cfg.get("type", "Ranger")).lower()
    if typ not in OPTIMIZER_TYPES:
        raise NotImplementedError(f"optimizer type {opt_cfg.get('type')}")
    lr = float(opt_cfg.get("lr", 1e-4))
    wd = float(opt_cfg.get("weight_decay", 0.0))
    momentum = float(opt_cfg.get("momentum", 0.9))
    own = ((int(opt_cfg.get("k", 6)), float(opt_cfg.get("alpha", 0.5))),)   # a Lookahead layer

    def tree(transform, layers=()):
        return lambda named, lr_, la=(): TreeOptimizer(named, transform, lr_, layers + tuple(la))

    if typ == "ranger":
        b1, b2 = _betas(opt_cfg, (0.95, 0.999))

        def make(named, lr_, la=()):
            return Ranger(named, lr=lr_, weight_decay=wd, betas=(b1, b2),
                          eps=float(opt_cfg.get("eps", 1e-5)), k=own[0][0], alpha=own[0][1],
                          use_gc=bool(opt_cfg.get("use_gc", True)), lookaheads=la)
    elif typ == "adam":
        make = tree(transforms.adam(weight_decay=wd if wd else None))
    elif typ == "adamw":
        make = tree(transforms.adam(weight_decay=wd))
    elif typ == "sgd":
        make = tree(transforms.sgd(momentum))
    elif typ == "radam":
        make = tree(transforms.radam())
    elif typ == "adabelief":
        make = tree(transforms.adabelief(eps=float(opt_cfg.get("eps", 1e-16))))
    elif typ in ("nadam", "nadamw"):
        make = tree(transforms.adam(weight_decay=wd if typ == "nadamw" else None, nesterov=True))
    elif typ in ("rmsprop", "rmsprop_tf"):
        # optax's eps_in_sqrt=True is the tf / caffe2 variant the reference ships as rmsprop_tf
        make = tree(transforms.rmsprop(float(opt_cfg.get("momentum", 0.0)) or None))
    elif typ == "lamb":
        make = tree(transforms.lamb(weight_decay=wd))
    elif typ == "lars":
        make = tree(transforms.lars(weight_decay=wd))
    elif typ == "ralamb":
        make = tree(extra.ralamb(weight_decay=wd))
    elif typ in ("over9000", "rangerlars"):
        make = tree(extra.over9000(weight_decay=wd), own)
    elif typ == "madgrad":
        make = tree(extra.madgrad(momentum=momentum, weight_decay=wd))
    elif typ == "adamp":
        make = tree(extra.adamp(weight_decay=wd))
    elif typ == "sgdp":
        make = tree(extra.sgdp(momentum=momentum, weight_decay=wd))
    elif typ in ("sgd_gc", "sgd_gcc"):
        make = tree(extra.sgd_gc(momentum=momentum, weight_decay=wd))
    elif typ == "ranger2020":
        b1, b2 = _betas(opt_cfg, (0.95, 0.999))
        make = tree(ranger_family.ranger2020(
            weight_decay=wd, b1=b1, b2=b2, eps=float(opt_cfg.get("eps", 1e-5)),
            use_gc=bool(opt_cfg.get("use_gc", True)),
            gc_conv_only=bool(opt_cfg.get("gc_conv_only", False)),
            gc_loc=bool(opt_cfg.get("gc_loc", True))), own)
    elif typ in ("rangeradabelief", "ranger_adabelief"):
        b1, b2 = _betas(opt_cfg, (0.95, 0.999))
        make = tree(ranger_family.ranger_adabelief(
            weight_decay=wd, b1=b1, b2=b2, eps=float(opt_cfg.get("eps", 1e-5)),
            use_gc=bool(opt_cfg.get("use_gc", True)),
            adabelief=bool(opt_cfg.get("adabelief", True)),
            weight_decouple=bool(opt_cfg.get("weight_decouple", True))), own)
    elif typ == "badam":
        b1, b2 = _betas(opt_cfg, (0.9, 0.999))
        make = tree(ranger_family.badam(
            # the reference's default 1e-2 when the key is absent only (`badam.py:35`);
            # an explicit 0.0 turns the decay off
            weight_decay=float(opt_cfg.get("weight_decay", 1e-2)), b1=b1, b2=b2,
            eps=float(opt_cfg.get("eps", 1e-6)),
            avg_sq_init=float(opt_cfg.get("avg_sq_init", 1e-3))))
    elif typ == "ranger21":
        b1, b2 = _betas(opt_cfg, (0.9, 0.999))
        make = tree(ranger_family.ranger21(
            # the reference's default when the key is absent only (`ranger21.py:111`)
            weight_decay=float(opt_cfg.get("weight_decay", 1e-4)), b1=b1, b2=b2,
            eps=float(opt_cfg.get("eps", 1e-8)),
            use_adaptive_gradient_clipping=bool(
                opt_cfg.get("use_adaptive_gradient_clipping", True)),
            using_gc=bool(opt_cfg.get("using_gc", True)),
            using_normgc=bool(opt_cfg.get("using_normgc", True)),
            normloss_active=bool(opt_cfg.get("normloss_active", True)),
            normloss_factor=float(opt_cfg.get("normloss_factor", 1e-4))),
            ((int(opt_cfg.get("lookahead_mergetime", 5)),
              float(opt_cfg.get("lookahead_blending_alpha", 0.5))),))
    else:   # "lookahead"
        inner_cfg = dict(opt_cfg.get("inner", {"type": "adam", "lr": lr}))
        inner_cfg.setdefault("lr", lr)
        inner_make, _ = _base_optimizer(inner_cfg)

        def make(named, lr_, la=()):
            # the inner optimizer reads the outer lr; its own layers come first
            return inner_make(named, lr_, own + tuple(la))
    return make, lr


def build_optimizer(solver_cfg: dict, named_params, lr_mults: dict | None = None,
                    frozen: tuple = ()) -> PortOptimizer:
    """The optimizer of SOLVER.OPTIMIZER_CFG over `named_params` ((name,
    parameter) pairs, e.g. `model.named_parameters()`), at its base lr.

    lr_mults: {top-level module name: multiplier} (LR_MULT), and frozen: the
    top-level names whose change is zeroed (FREEZE), both applied to the
    final parameter change (`optimizer.PortOptimizer`).
    SOLVER.CLIP_GRADIENTS clips before the optimizer; a CLIP_TYPE other than
    value / norm / full_model raises."""
    named = list(named_params)
    opt_cfg = dict(solver_cfg.get("OPTIMIZER_CFG", {"type": "Ranger", "lr": 1e-4}))
    make, base_lr = _base_optimizer(opt_cfg)
    mults = dict(lr_mults or {})
    mults.update(dict.fromkeys(frozen, 0.0))
    clip = None
    clip_cfg = solver_cfg.get("CLIP_GRADIENTS", {})
    if clip_cfg.get("ENABLED", False):
        clip = (str(clip_cfg.get("CLIP_TYPE", "value")), float(clip_cfg.get("CLIP_VALUE", 1.0)))
        if clip[0] not in CLIP_TYPES:
            raise ValueError(f"SOLVER.CLIP_GRADIENTS.CLIP_TYPE = {clip[0]!r}: the port clips by "
                             "value, norm or full_model (the JAX package ignores any other "
                             "type without a word)")
    opt = make(named, base_lr)
    opt.clip = clip
    opt.mults = {p: float(mults[name.split(".", 1)[0]]) for name, p in named
                 if float(mults.get(name.split(".", 1)[0], 1.0)) != 1.0}
    return opt


def optimizer_from_config(cfg, model) -> PortOptimizer:
    """`build_optimizer` for a whole config and a port model: LR_MULT of the
    rotation and TS heads, FREEZE of PCLNET and both heads (the modules
    `pcl_net`, `rot_head`, `ts_head`)."""
    net = cfg.MODEL.CATRE
    lr_mults = {"rot_head": float(net.ROT_HEAD.get("LR_MULT", 1.0)),
                "ts_head": float(net.TS_HEAD.get("LR_MULT", 1.0))}
    frozen = tuple(key for key, sub in (("pcl_net", net.PCLNET), ("rot_head", net.ROT_HEAD),
                                        ("ts_head", net.TS_HEAD)) if sub.get("FREEZE", False))
    return build_optimizer(cfg.SOLVER, model.named_parameters(), lr_mults, frozen)
