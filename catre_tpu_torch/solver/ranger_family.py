"""The Ranger family of the registry: ranger2020, ranger_adabelief, badam and
ranger21, as transforms over the leaves (`optimizer.TreeOptimizer`).

Counterpart of `catre_tpu/solver/ranger_family.py`: `_gc` (:45), `_rect_terms`
(:65; here `ranger.rect_terms`, its scalars in the -expm1(t log b) form, since
the naive float32 subtraction flips the branch near n_sma = 5), `_ranger_core`
(:97), `ranger2020` (:183), `ranger_adabelief` (:192), `badam` (:209) and
`ranger21` (:271). The port follows the JAX package, not the reference, where
its docstring says so:
  - the AdaBelief quirk: in the rectified branch eps is added INTO the stored
    second moment, so it accumulates across steps (:134-136;
    `ranger_adabelief.py:233` uses `add_`);
  - the aliasing quirk of the non-rectified branch: the stored first moment
    takes the decoupled decay and the gc_loc=False centralisation (:138-163);
  - ranger21's stable weight decay and norm loss act on every parameter,
    not on the reference's one stale `p` of its phase 2 (`ranger21.py:455-476`).
Their Lookahead is not here: the registry gives ranger2020 and
ranger_adabelief their (k, alpha), and ranger21 its (lookahead_mergetime,
lookahead_blending_alpha), as the first Lookahead layer of
`optimizer.PortOptimizer`, which acts after the update and before the
LR_MULT / FREEZE multipliers, as JAX's Lookahead does. The options of the JAX
functions that its `build.py` never sets are this module's constants (the
rectification threshold 5; ranger21's softplus with beta 50, AGC at 1e-2 /
1e-3, PNM factor 1 and GC over every axis but 0).

The layout: a rotation head's layer-0 pair arrives joined (flax's leaf
transposed), so GC (ranger2020's `gc_conv_only` included), ranger21's
adaptive gradient clipping, unit norm, gradient normalisation and norm loss
run over the whole flax leaf; every axis-wise reduction runs over every axis
but 0, the output axis here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .extra import centralize
from .optimizer import Step, Transform, f32_pow
from .ranger import rect_terms

AGC_CLIPPING_VALUE, AGC_EPS = 1e-2, 1e-3    # ranger21's adaptive gradient clipping
PNM_MOMENTUM_FACTOR = 1.0                   # its positive-negative momentum
BETA_SOFTPLUS = 50.0                        # its softplus'd denominator
NORMGC_EPS = 1e-8                           # its gradient normalisation


def _gc(g: torch.Tensor, gc_conv_only: bool, name: str) -> torch.Tensor:
    """Gradient centralisation (`ranger2020.py:31-57`); with gc_conv_only only
    leaves of more than three axes (none in this model)."""
    if gc_conv_only:
        return g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True) if g.dim() > 3 else g
    return centralize(g, name)


class _RangerCore(Transform):
    """Shared body of ranger2020 and ranger_adabelief."""

    def __init__(self, b1, b2, eps, weight_decay, use_gc, gc_conv_only, gc_loc, adabelief,
                 weight_decouple):
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.use_gc, self.gc_conv_only, self.gc_loc = use_gc, gc_conv_only, gc_loc
        self.adabelief, self.weight_decouple = adabelief, weight_decouple

    def init(self, param):
        return {"exp_avg": torch.zeros_like(param), "exp_avg_sq": torch.zeros_like(param)}

    def _tail(self, G, p, name):
        if self.weight_decouple and self.weight_decay != 0.0:
            G = G + self.weight_decay * p
        if self.use_gc and not self.gc_loc:
            G = _gc(G, self.gc_conv_only, name)
        return G

    def update(self, grads, params, states, step: Step):
        b1, b2, eps, lr, t = self.b1, self.b2, self.eps, step.lr, step.t
        rectified, step_rect, one_minus_beta1_t = rect_terms(t, b1, b2)
        out = []
        for g, p, s, name in zip(grads, params, states, step.names):
            if not self.weight_decouple and self.weight_decay != 0.0:
                g = g + self.weight_decay * p     # coupled decay before GC
            if self.use_gc and self.gc_loc:
                g = _gc(g, self.gc_conv_only, name)
            m = b1 * s["exp_avg"] + (1 - b1) * g
            if self.adabelief:
                v = b2 * s["exp_avg_sq"] + (1 - b2) * (g - m) * (g - m)
            else:
                v = b2 * s["exp_avg_sq"] + (1 - b2) * g * g
            if rectified:
                if self.adabelief:
                    v = v + eps
                u = -lr * step_rect * self._tail(m / (torch.sqrt(v) + eps), p, name)
            else:
                m = self._tail(m, p, name)
                u = -lr * (1.0 / one_minus_beta1_t) * m
            s["exp_avg"], s["exp_avg_sq"] = m, v
            out.append(u)
        return out


def ranger2020(b1=0.95, b2=0.999, eps=1e-5, weight_decay=0.0, use_gc=True, gc_conv_only=False,
               gc_loc=True) -> Transform:
    return _RangerCore(b1, b2, eps, weight_decay, use_gc, gc_conv_only, gc_loc,
                       adabelief=False, weight_decouple=True)


def ranger_adabelief(b1=0.95, b2=0.999, eps=1e-5, weight_decay=0.0, use_gc=True,
                     adabelief=True, weight_decouple=True) -> Transform:
    return _RangerCore(b1, b2, eps, weight_decay, use_gc, gc_conv_only=False, gc_loc=True,
                       adabelief=adabelief, weight_decouple=weight_decouple)


class badam(Transform):
    """AdamW-style multiplicative decay, eps inside the root, the second
    moment started at `avg_sq_init` and no bias correction (`badam.py:7-112`):
    p <- p (1 - lr wd) - lr m / sqrt(v + eps)."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-6, weight_decay=1e-2, avg_sq_init=1e-3):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.avg_sq_init = weight_decay, avg_sq_init

    def init(self, param):
        return {"exp_avg": torch.zeros_like(param),
                "exp_avg_sq": torch.full_like(param, self.avg_sq_init)}

    def update(self, grads, params, states, step):
        b1, b2, lr = self.b1, self.b2, step.lr
        out = []
        for g, p, s in zip(grads, params, states):
            s["exp_avg"] = b1 * s["exp_avg"] + (1 - b1) * g
            s["exp_avg_sq"] = b2 * s["exp_avg_sq"] + (1 - b2) * g * g
            out.append(-lr * self.weight_decay * p
                       - lr * s["exp_avg"] / torch.sqrt(s["exp_avg_sq"] + self.eps))
        return out


def _unit_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm over every axis but 0 (`ranger21.py:251-269`); the whole tensor's
    for one axis or none."""
    if x.dim() <= 1:
        return torch.linalg.vector_norm(x)
    return torch.sqrt((x * x).sum(dim=tuple(range(1, x.dim())), keepdim=True))


def _agc(p, g):
    """Adaptive gradient clipping (`ranger21.py:271-291`)."""
    max_norm = torch.clamp(_unit_norm(p), min=AGC_EPS) * AGC_CLIPPING_VALUE
    g_norm = _unit_norm(g)
    return torch.where(g_norm > max_norm, g * (max_norm / torch.clamp(g_norm, min=1e-6)), g)


def _grad_normalize(g):
    """g over its standard deviation (torch's unbiased), for more than two
    elements (`ranger21.py:54-67`)."""
    if g.numel() <= 2:
        return g
    return g / (torch.std(g, correction=1) + NORMGC_EPS)


class ranger21(Transform):
    """Ranger21's AdamW core with positive-negative momentum, a softplus'd
    denominator, stable weight decay and norm loss (the reference's default
    engine; its madgrad core is dead in its config); its Lookahead is a layer
    (see above). The gradient is prepared twice, as the reference mutates
    `p.grad` in its phase 1 and prepares it again in phase 2: AGC, GC,
    normalisation, then GC and normalisation again on the result
    (`ranger21.py:383-400`, :577-583)."""

    def __init__(self, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8,
                 use_adaptive_gradient_clipping=True, using_gc=True, using_normgc=True,
                 normloss_active=True, normloss_factor=1e-4):
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.use_agc, self.using_gc = use_adaptive_gradient_clipping, using_gc
        self.using_normgc = using_normgc
        self.normloss_active, self.normloss_factor = normloss_active, normloss_factor

    def init(self, param):
        return {"grad_ma": torch.zeros_like(param), "neg_grad_ma": torch.zeros_like(param),
                "variance_ma": torch.zeros_like(param)}

    def _prep(self, p, g, second_pass: bool, name: str):
        if self.use_agc and not second_pass:
            g = _agc(p, g)
        if self.using_gc:
            g = centralize(g, name)
        if self.using_normgc:
            g = _grad_normalize(g)
        return g

    def update(self, grads, params, states, step: Step):
        b1, b2, eps, lr, t = self.b1, self.b2, self.eps, step.lr, step.t
        bc1 = float(np.float32(1.0) - f32_pow(b1, t))
        bc2 = float(np.float32(1.0) - f32_pow(b2, t))
        grad1 = [self._prep(p, g, False, n) for p, g, n in zip(params, grads, step.names)]
        for s, g in zip(states, grad1):
            s["variance_ma"] = b2 * s["variance_ma"] + (1 - b2) * g * g
        # stable weight decay's scale: the global debiased-variance RMS (`ranger21.py:427-447`)
        var_sum = sum(s["variance_ma"].sum() for s in states)
        n_params = sum(s["variance_ma"].numel() for s in states)
        variance_normalized = torch.sqrt(var_sum / bc2 / n_params)
        # the pnm noise norm from b2, as the reference (`ranger21.py:591`); upstream uses b1
        noise_norm = math.sqrt((1.0 + b2) ** 2 + b2 ** 2)
        odd = t % 2 == 1
        out = []
        for p, g, s, name in zip(params, grad1, states, step.names):
            g2 = self._prep(p, g, True, name)
            # positive-negative momentum: the buffers take turns by the step's parity
            cur, other = ("grad_ma", "neg_grad_ma") if odd else ("neg_grad_ma", "grad_ma")
            ma = (b1 ** 2) * s[cur] + (1 - b1 ** 2) * g2
            neg = s[other]
            s[cur] = ma
            denom = torch.sqrt(s["variance_ma"]) / math.sqrt(bc2) + eps
            denom = F.softplus(BETA_SOFTPLUS * denom) / BETA_SOFTPLUS
            pnm = (ma * (1 + PNM_MOMENTUM_FACTOR) - PNM_MOMENTUM_FACTOR * neg) / noise_norm
            p_new = p
            if self.weight_decay:
                p_new = p_new * (1 - self.weight_decay * lr / variance_normalized)
            if self.normloss_active:
                correction = 2 * self.normloss_factor * (1 - 1.0 / (_unit_norm(p_new) + eps))
                p_new = p_new * (1 - lr * correction)
            out.append(p_new - (lr / bc1) * pnm / denom - p)
        return out
