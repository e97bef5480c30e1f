"""Ranger: gradient centralisation, RAdam, Lookahead.

Counterpart of `catre_tpu/solver/ranger.py::ranger` (:52-133), itself the
reference's `lib/torch_utils/solver/ranger.py`, as a `torch.optim.Optimizer`:
  - gradient centralisation (GC) first: a weight's gradient loses its mean
    over every axis but the output axis 0; `point_weight` (P,) loses its mean
    over all elements (the name exception at :44); other 1-D parameters are
    left alone. A rotation head's layer-0 weight is one flax kernel
    (1088, 256) but two port parameters, `layer0_global_weight` (256, 1024)
    and `layer0_point_weight` (256, 64): they are centralised jointly, over
    the 1088 inputs of each output row, or the optimizer would differ;
  - RAdam with betas (0.95, 0.999) and eps 1e-5, rectified once
    n_sma > 5, its scalars in the -expm1(t log b) form (:90-107);
  - decoupled weight decay, p -= wd * lr * p;
  - Lookahead: every k = 6 steps the slow copy (its own tensor, never the
    parameter's storage) moves alpha = 0.5 toward the fast weights and the
    fast weights snap to it; this is the first Lookahead layer of
    `optimizer.PortOptimizer`, the one that `lookahead` and the Ranger family
    use too.
The learning rate is read from `param_groups` at every step; the train step
sets it once per outer step, as `_set_lr` (`engine/train.py:60`) does.
`rect_terms` gives the RAdam scalars to the Ranger family too
(`ranger_family.py`), as `_rect_terms` does in the JAX package.
"""

from __future__ import annotations

import math

import torch

from .optimizer import PortOptimizer


N_SMA_THRESHOLD = 5.0


def rect_terms(t: int, b1: float, b2: float):
    """RAdam's rectification at step t -> (rectified, step_rect, 1 - b1^t),
    1 - b^t as -expm1(t log b): the naive float32 subtraction flips the branch
    near n_sma = 5 (`catre_tpu/solver/ranger_family.py::_rect_terms`)."""
    beta2_t = math.exp(t * math.log(b2))
    one_minus_beta2_t = -math.expm1(t * math.log(b2))
    n_sma_max = 2.0 / (1.0 - b2) - 1.0
    n_sma = n_sma_max - 2.0 * t * beta2_t / one_minus_beta2_t
    one_minus_beta1_t = -math.expm1(t * math.log(b1))
    step_rect = math.sqrt(max(
        one_minus_beta2_t * (n_sma - 4.0) / (n_sma_max - 4.0)
        * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0), 0.0)) / one_minus_beta1_t
    return n_sma > N_SMA_THRESHOLD, step_rect, one_minus_beta1_t


def gc_rules(named_params) -> dict:
    """name -> 'rows' (mean over all axes but 0), 'all', 'joint:<partner>'
    or None, for the parameters of a port model."""
    names = [n for n, _ in named_params]
    rules = {}
    for n in names:
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "layer0_global_weight":
            rules[n] = "joint:" + n[: -len("global_weight")] + "point_weight"
        elif leaf == "layer0_point_weight":
            rules[n] = "joint:" + n[: -len("point_weight")] + "global_weight"
        elif leaf == "point_weight":
            rules[n] = "all"
        else:
            rules[n] = None
    return rules


class Ranger(PortOptimizer):
    """Ranger over named parameters (the names decide the GC rule)."""

    def __init__(self, named_params, lr: float = 1e-3, alpha: float = 0.5, k: int = 6,
                 betas=(0.95, 0.999), eps: float = 1e-5, weight_decay: float = 0.0,
                 use_gc: bool = True, lookaheads=()):
        named = list(named_params)
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, use_gc=use_gc)
        super().__init__(named, defaults, ((k, alpha),) + tuple(lookaheads))
        by_name = dict(named)
        self._rule = {}
        for n, rule in gc_rules(named).items():
            p = by_name[n]
            if rule and rule.startswith("joint:"):
                self._rule[p] = ("joint", by_name[rule[len("joint:"):]])
            elif rule == "all" or (rule is None and p.dim() > 1):
                self._rule[p] = ("all", None) if rule == "all" else ("rows", None)

    def _centralized(self, params) -> dict:
        grads = {p: p.grad for p in params if p.grad is not None}
        out = dict(grads)
        for p, g in grads.items():
            kind, partner = self._rule.get(p, (None, None))
            if kind == "all":
                out[p] = g - g.mean()
            elif kind == "rows":
                out[p] = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
            elif kind == "joint":
                g2 = grads[partner]
                mean = (g.sum(dim=1, keepdim=True) + g2.sum(dim=1, keepdim=True)) / (
                    g.shape[1] + g2.shape[1])
                out[p] = g - mean
        return out

    def _update(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            grads = self._centralized(params) if group["use_gc"] else {p: p.grad for p in params}
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in params:
                state = self.state[p]
                if "step" not in state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                g = grads[p]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)

                rectified, step_rect, one_minus_beta1_t = rect_terms(t, b1, b2)
                if rectified:
                    upd = -lr * step_rect * m / (v.sqrt() + eps)
                else:
                    upd = -lr / one_minus_beta1_t * m
                if wd != 0.0:
                    upd = upd - wd * lr * p
                p.add_(upd)
