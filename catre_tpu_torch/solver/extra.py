"""The registry's optimizers beyond Ranger that the JAX package composes or
writes itself.

Counterpart of `catre_tpu/solver/extra.py`: `gradient_centralization` (:37),
`lookahead_wrap` (:56; here the Lookahead layers of
`optimizer.PortOptimizer`, applied per parameter after any optimizer's
update, so that `lookahead` can wrap every type, Ranger included), `ralamb`
(:91), `over9000` (:102), `madgrad` (:117), AdamP / SGDP's `_projection` and
`_projected` (:156-200), `adamp`, `sgdp` and `sgd_gc` (:202-225).

The layout: flax keeps a kernel's output axis last, the port first, so
"every axis but the last" there is "every axis but 0" here. A rotation head's
layer-0 pair reaches these transforms joined (`optimizer.TreeOptimizer`):
centralisation, Ralamb's trust ratio and AdamP / SGDP's projection and cosine
test run over the whole flax leaf, as in JAX; per half they would differ.
`point_weight` (P,) is a Conv1d weight (1, P, 1) in the reference and is
centralised over all its elements.

The options of the JAX functions that its `build.py` never sets are
constants here: MADGRAD's eps 1e-6, AdamP / SGDP's delta 0.1 and wd_ratio 0.1.
"""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Step, Transform
from .transforms import (add_decayed_weights, chain, scale_by_adam, scale_by_lr, scale_by_radam,
                         scale_by_trust_ratio, trace)

MADGRAD_EPS = 1e-6
PROJ_DELTA, PROJ_WD_RATIO = 0.1, 0.1      # AdamP / SGDP's cosine threshold and decay damping


def centralize(g: torch.Tensor, name: str) -> torch.Tensor:
    """Gradient centralisation of one leaf (`ranger.py::_centralize` :39)."""
    if name == "point_weight":
        return g - g.mean()
    if g.dim() > 1:
        return g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
    return g


class gradient_centralization(Transform):
    def update(self, grads, params, states, step: Step):
        return [centralize(g, name) for g, name in zip(grads, step.names)]


def ralamb(weight_decay: float = 0.0) -> Transform:
    """RAdam's direction scaled by the layer-wise trust ratio
    (`lib/torch_utils/solver/ralamb.py`)."""
    decay = (add_decayed_weights(weight_decay),) if weight_decay else ()
    return chain(scale_by_radam(), *decay, scale_by_trust_ratio(),
                 scale_by_lr())


def over9000(weight_decay: float = 0.0) -> Transform:
    """RangerLars without its Lookahead (the registry adds that layer):
    GC, then Ralamb (`lib/torch_utils/solver/over9000.py`)."""
    return chain(gradient_centralization(), ralamb(weight_decay))


class madgrad(Transform):
    """MADGRAD (Defazio & Jelassi 2021; `lib/torch_utils/solver/madgrad.py`):
    dual averaging with cube-root denominators and iterate averaging.
    lambda = lr sqrt(t + 1) in float32 at the 0-based step t."""

    def __init__(self, momentum: float = 0.9, weight_decay: float = 0.0):
        self.momentum, self.weight_decay = momentum, weight_decay

    def init(self, param):
        return {"grad_sum": torch.zeros_like(param), "grad_sum_sq": torch.zeros_like(param),
                "x0": param.detach().clone()}

    def update(self, grads, params, states, step):
        lamb = float(np.float32(step.lr) * np.sqrt(np.float32(step.t - 1) + np.float32(1.0)))
        out = []
        for g, p, s in zip(grads, params, states):
            if self.weight_decay:
                g = g + self.weight_decay * p
            s["grad_sum"] = s["grad_sum"] + lamb * g
            s["grad_sum_sq"] = s["grad_sum_sq"] + lamb * g * g
            z = s["x0"] - s["grad_sum"] / (s["grad_sum_sq"].pow(1.0 / 3.0) + MADGRAD_EPS)
            out.append((1.0 - self.momentum) * p + self.momentum * z - p)
        return out


class _projected(Transform):
    """AdamP / SGDP (`lib/torch_utils/solver/adamp.py:14-43`): where a leaf
    of two or more axes and its step direction are nearly orthogonal
    (|cos| < PROJ_DELTA / sqrt(numel): the step mostly rescales the weight),
    the radial part of the step is removed and the weight decay damped by
    PROJ_WD_RATIO."""

    def __init__(self, base: Transform, weight_decay: float):
        self.base, self.weight_decay = base, weight_decay

    def init(self, param):
        return self.base.init(param)

    def project(self, p, d):
        if p.dim() < 2:
            return d, 1.0
        pf, df = p.reshape(-1), d.reshape(-1)
        pn = pf / (torch.linalg.vector_norm(pf) + 1e-12)
        dot = torch.dot(pn, df)
        cos = dot.abs() / (torch.linalg.vector_norm(df) + 1e-12)
        on_scale = cos < PROJ_DELTA / np.sqrt(np.float32(pf.shape[0]))
        out = torch.where(on_scale, df - dot * pn, df).reshape(d.shape)
        ratio = torch.where(on_scale, torch.full_like(cos, PROJ_WD_RATIO), torch.ones_like(cos))
        return out, ratio

    def update(self, grads, params, states, step):
        out = []
        for p, d in zip(params, self.base.update(grads, params, states, step)):
            d2, ratio = self.project(p, d)
            upd = -step.lr * d2
            if self.weight_decay:
                upd = upd - step.lr * self.weight_decay * ratio * p
            out.append(upd)
        return out


def adamp(weight_decay: float = 0.0) -> Transform:
    return _projected(scale_by_adam(), weight_decay)


def sgdp(momentum: float = 0.9, weight_decay: float = 0.0) -> Transform:
    return _projected(trace(momentum), weight_decay)


def sgd_gc(momentum: float = 0.9, weight_decay: float = 0.0) -> Transform:
    """SGD with gradient centralisation (`lib/torch_utils/solver/sgd_gc.py`);
    GCC (conv only) is the same here: every parameter of two or more axes in
    this model is a kernel."""
    decay = (add_decayed_weights(weight_decay),) if weight_decay else ()
    return chain(gradient_centralization(), *decay, trace(momentum), scale_by_lr())
