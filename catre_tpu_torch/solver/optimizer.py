"""The port's optimizers: a base that adds what the SOLVER config and the
heads' LR_MULT / FREEZE flags add around any optimizer type, and the class
that runs the registry's optax-style transforms.

Counterpart of what `catre_tpu/solver/build.py::build_optimizer` (:159-205)
chains around the optimizer of `_base_optimizer`, in JAX's order:
  1. gradient clipping, before the optimizer and after the train step's NaN
     scrub (`optax.chain(clip, tx)`, :197-204): "value" clamps each element to
     [-v, v] (`optax.clip`); "norm" and "full_model" are one global norm over
     every gradient, scaled by `g / ||g|| * v` only when ||g|| >= v
     (`optax.clip_by_global_norm`; `torch.nn.utils.clip_grad_norm_` adds 1e-6
     to the norm and is another function). JAX ignores any other CLIP_TYPE;
     the port raises (ROADMAP queue 3);
  2. the optimizer's own update, Lookahead layers included
     (`extra.lookahead_wrap`, applied here per parameter, innermost first);
  3. the multipliers: LR_MULT scales, and FREEZE zeroes, the FINAL parameter
     change of a top-level subtree (`scale_tree` chained after the optimizer,
     :176-193): p <- p_old + mult * (p_stepped - p_old), after decoupled
     weight decay and after a Lookahead sync, while the moments and the slow
     copies advance unscaled; a frozen parameter keeps its bits. A per-group
     learning rate, the reference's way, is another function once weight
     decay or Lookahead acts.

The split layer-0 kernel: the flax layer-0 kernel of a rotation head is one
leaf (1088, 256); the port holds it as `layer0_global_weight` (256, 1024) and
`layer0_point_weight` (256, 64). Every per-leaf quantity (trust ratios,
projections, norms, standard deviations, centralisation) must be computed over
the pair, or the optimizer differs without a word. `TreeOptimizer` hands its
transform the pair joined along dim 1, (256, 1088) = the flax leaf
transposed, and splits the update back; its state for the pair lives under
`layer0_global_weight`. Flax reduces over every axis but the last, the port
over every axis but 0: the same elements.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CLIP_TYPES = ("value", "norm", "full_model")
_F32_TINY = float(np.finfo(np.float32).tiny)


def f32_pow(base: float, t) -> np.float32:
    """base ** t in float32 as XLA computes `decay ** count` on the CPU
    (powf; a denormal result flushed to 0), for the scalars whose f32
    rounding decides a branch (RAdam's rho) or a bias correction."""
    out = np.float32(base) ** np.float32(t)
    return np.float32(0.0) if out < _F32_TINY else out


def clip_gradients_(grads, clip_type: str, clip_value: float) -> None:
    """Clip `grads` in place: "value" as `optax.clip`, any other of
    CLIP_TYPES as `optax.clip_by_global_norm`."""
    if clip_type == "value":
        for g in grads:
            g.clamp_(-clip_value, clip_value)
        return
    if not grads:
        return
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < clip_value
    # (g / norm) * max, optax's order; g / 1 * 1 is g's bits
    denom = torch.where(keep, torch.ones_like(norm), norm)
    numer = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, clip_value))
    for g in grads:
        g.div_(denom).mul_(numer)


def slow_key(i: int) -> str:
    """The state key of the i-th Lookahead layer's slow copy, innermost
    first: "slow", then "slow1", "slow2", ..."""
    return f"slow{i}" if i else "slow"


class PortOptimizer(torch.optim.Optimizer):
    """A `torch.optim.Optimizer` over named parameters whose `step()` clips
    (`clip`), runs `_update()` and the Lookahead layers (`lookaheads`, (k,
    alpha) pairs, innermost first), then applies the multipliers (`mults`,
    parameter -> factor, FREEZE being 0). Subclasses implement `_update()`,
    reading the learning rate from `param_groups` at every step.

    A Lookahead layer keeps per parameter a slow copy (`slow_key`, its own
    tensor, never the parameter's storage), made from the parameter at the
    first step; the layers share one count, "lookahead_step". Every k steps
    the slow copy moves alpha toward the fast weights and they snap to it.
    Ranger's own Lookahead and that of the Ranger family are the first layer,
    as the multipliers act after it in JAX too."""

    def __init__(self, named_params, defaults: dict, lookaheads=()):
        super().__init__([p for _, p in named_params], defaults)
        self.lookaheads = tuple((int(k), float(alpha)) for k, alpha in lookaheads)
        self.clip = None          # (CLIP_TYPE, CLIP_VALUE) or None
        self.mults = {}           # parameter -> multiplier other than 1

    def _update(self) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        params = [p for group in self.param_groups for p in group["params"]]
        if self.clip is not None:
            clip_gradients_([p.grad for p in params if p.grad is not None], *self.clip)
        if self.lookaheads:
            for p in params:
                state = self.state[p]
                if "lookahead_step" not in state:
                    state["lookahead_step"] = 0
                    for i in range(len(self.lookaheads)):
                        state[slow_key(i)] = p.detach().clone()
        before = [(p, m, p.detach().clone()) for p, m in self.mults.items()]
        self._update()
        for p in params if self.lookaheads else ():
            state = self.state[p]
            state["lookahead_step"] += 1
            for i, (k, alpha) in enumerate(self.lookaheads):
                if state["lookahead_step"] % k == 0:
                    slow = state[slow_key(i)]
                    slow.add_(p - slow, alpha=alpha)
                    p.copy_(slow)
        for p, m, old in before:
            p.copy_(old.add_(p - old, alpha=m) if m else old)
        return None


def leaf_groups(named_params) -> list:
    """The JAX package's leaves over the port's parameters: [(leaf name,
    [parameter, ...])], a rotation head's `layer0_global_weight` and
    `layer0_point_weight` as one leaf `layer0_kernel` (the pair, joined along
    dim 1), every other parameter a leaf of its own named by its last
    component."""
    by_name = dict(named_params)
    leaves = []
    for name, p in by_name.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "layer0_point_weight":
            continue
        if leaf == "layer0_global_weight":
            partner = (prefix + "." if prefix else "") + "layer0_point_weight"
            leaves.append(("layer0_kernel", [p, by_name[partner]]))
        else:
            leaves.append((leaf, [p]))
    return leaves


class Step(NamedTuple):
    """What a transform reads besides the leaves: the learning rate, the
    1-based count of this update, and the leaves' names."""

    lr: float
    t: int
    names: list


class Transform:
    """An optax GradientTransformation over the leaves. `init(param)` -> the
    leaf's state entries; `update(grads, params, states, step)` -> the
    updates, storing each leaf's new entries into `states[i]`."""

    def init(self, param: torch.Tensor) -> dict:
        return {}

    def update(self, grads, params, states, step: Step) -> list:
        raise NotImplementedError


class TreeOptimizer(PortOptimizer):
    """A `Transform` as a `torch.optim.Optimizer`: each step hands it the
    leaves (`leaf_groups`), gradients absent from the backward as zeros, and
    adds its updates, p + u (`optax.apply_updates`). The state is made at the
    first step, from the parameters then, and "step" counts the updates."""

    def __init__(self, named_params, transform: Transform, lr: float, lookaheads=()):
        named = list(named_params)
        super().__init__(named, dict(lr=lr), lookaheads)
        self.transform = transform
        self.leaves = leaf_groups(named)

    def _update(self) -> None:
        grads, params, states = [], [], []
        for _, ps in self.leaves:
            g = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            grads.append(g[0] if len(ps) == 1 else torch.cat(g, dim=1))
            params.append(ps[0].detach() if len(ps) == 1 else torch.cat(ps, dim=1))
            state = self.state[ps[0]]
            if "step" not in state:
                state["step"] = 0
                state.update(self.transform.init(params[-1]))
            state["step"] += 1
            states.append(state)
        step = Step(float(self.param_groups[0]["lr"]), states[0]["step"],
                    [name for name, _ in self.leaves])
        updates = self.transform.update(grads, params, states, step)
        for (_, ps), u in zip(self.leaves, updates):
            parts = [u] if len(ps) == 1 else u.split([p.shape[1] for p in ps], dim=1)
            for p, part in zip(ps, parts):
                p.add_(part)
