"""The optax transformations that the registry composes, in plain PyTorch.

Counterparts of optax 0.2.6 as the JAX package runs it (`optax/_src/
transform.py`, `alias.py`, `transforms/_accumulation.py`, `_adding.py`), with
optax's order of operations: `scale_by_adam` (nesterov for NAdam),
`scale_by_belief` (AdaBelief), `scale_by_radam`, `scale_by_rms`, `trace`,
`add_decayed_weights`, `scale_by_trust_ratio` and the learning-rate scale,
and `chain`. The aliases `adam`, `adamw`, `nadam(w)`, `sgd`, `radam`,
`adabelief`, `rmsprop`, `lamb` and `lars` chain them as optax does.

`torch.optim` has none of these as the same function: its NAdam applies a
momentum-decay schedule that `optax.nadam` lacks; its RMSprop adds eps outside
the root and decays by 0.99, where `optax.rmsprop` decays by 0.9 with
`eps_in_sqrt=True` and a zero initial scale; AdaBelief, LAMB and LARS
(`trust_coefficient` 1e-3, eps 0) it does not have.

Scalars that optax computes from the step count in float32 (`decay ** count`,
the bias corrections, RAdam's rho) are computed here in float32 on the host
(`optimizer.f32_pow`): RAdam's branch at rho >= 5 and its rectification factor
move by a percent with one float32 ulp of b2 ** t at t = 6. Per-leaf norms run
over the joined layer-0 pair (`optimizer.TreeOptimizer`). The options that
the registry never sets are constants at optax's defaults: b1 0.9, b2 0.999,
eps_root 0 (AdaBelief's 1e-16), RAdam's threshold 5, RMSprop's decay 0.9, eps
1e-8 and initial scale 0, no Nesterov momentum in `trace`.
"""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Step, Transform, f32_pow

B1, B2 = 0.9, 0.999                # the moments' decays of every Adam-like transform
BELIEF_EPS_ROOT = 1e-16            # `optax.scale_by_belief`'s eps_root
RADAM_THRESHOLD = 5.0              # `optax.scale_by_radam`'s threshold
RMS_DECAY, RMS_EPS = 0.9, 1e-8     # `optax.rmsprop`'s decay and eps (initial scale 0)


def _bias_corrected(x: torch.Tensor, decay: float, t) -> torch.Tensor:
    """x / (1 - decay ** t), the denominator in float32 (`tree.bias_correction`)."""
    return x / float(np.float32(1.0) - f32_pow(decay, t))


def _nesterov_hat(mu, g, t: int):
    """b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t) (optax's nesterov)."""
    return B1 * _bias_corrected(mu, B1, t + 1) + (1 - B1) * _bias_corrected(g, B1, t)


class chain(Transform):
    """`optax.chain`: the transforms in turn; their state entries share a
    leaf's dict, so their keys must differ."""

    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, param):
        out = {}
        for tr in self.transforms:
            entries = tr.init(param)
            if out.keys() & entries.keys():
                raise ValueError(f"chain: state keys {sorted(out.keys() & entries.keys())} "
                                 "of two transforms collide")
            out.update(entries)
        return out

    def update(self, grads, params, states, step: Step):
        for tr in self.transforms:
            grads = tr.update(grads, params, states, step)
        return grads


class scale_by_adam(Transform):
    """`optax.scale_by_adam` (mu, nu; nesterov for NAdam)."""

    def __init__(self, eps=1e-8, nesterov=False):
        self.eps, self.nesterov = eps, nesterov

    def init(self, param):
        return {"mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}

    def update(self, grads, params, states, step):
        t = step.t
        out = []
        for g, s in zip(grads, states):
            s["mu"] = (1 - B1) * g + B1 * s["mu"]
            s["nu"] = (1 - B2) * (g * g) + B2 * s["nu"]
            mu_hat = (_nesterov_hat(s["mu"], g, t) if self.nesterov
                      else _bias_corrected(s["mu"], B1, t))
            nu_hat = _bias_corrected(s["nu"], B2, t)
            out.append(mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return out


class scale_by_belief(Transform):
    """`optax.scale_by_belief` (AdaBelief: the second moment of g - mu, plus
    eps_root into the stored moment)."""

    def __init__(self, eps=1e-16):
        self.eps = eps

    def init(self, param):
        return {"mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}

    def update(self, grads, params, states, step):
        t = step.t
        out = []
        for g, s in zip(grads, states):
            s["mu"] = (1 - B1) * g + B1 * s["mu"]
            err = g - s["mu"]
            s["nu"] = (1 - B2) * (err * err) + B2 * s["nu"] + BELIEF_EPS_ROOT
            out.append(_bias_corrected(s["mu"], B1, t)
                       / (torch.sqrt(_bias_corrected(s["nu"], B2, t)) + self.eps))
        return out


class scale_by_radam(Transform):
    """`optax.scale_by_radam`: rectified once rho >= threshold, else the
    bias-corrected first moment; rho and the rectification factor r in
    float32, in optax's order of operations."""

    eps = 1e-8
    ro_inf = 2.0 / (1.0 - B2) - 1.0

    def init(self, param):
        return {"mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}

    def rho(self, t: int) -> np.float32:
        f32 = np.float32
        b2t = f32_pow(B2, t)
        return f32(self.ro_inf) - f32(f32(2 * t) * b2t) / (f32(1.0) - b2t)

    def rectification(self, ro: np.float32) -> float:
        f32 = np.float32
        return float(np.sqrt(f32(f32((ro - f32(4.0)) * (ro - f32(2.0))) * f32(self.ro_inf))
                             / f32(f32((self.ro_inf - 4.0) * (self.ro_inf - 2.0)) * ro)))

    def update(self, grads, params, states, step):
        t = step.t
        ro = self.rho(t)
        r = self.rectification(ro) if ro >= RADAM_THRESHOLD else None
        out = []
        for g, s in zip(grads, states):
            s["mu"] = (1 - B1) * g + B1 * s["mu"]
            s["nu"] = (1 - B2) * (g * g) + B2 * s["nu"]
            mu_hat = _bias_corrected(s["mu"], B1, t)
            if r is not None:
                nu_hat = _bias_corrected(s["nu"], B2, t)
                out.append(r * mu_hat / (torch.sqrt(nu_hat) + self.eps))
            else:
                out.append(mu_hat)
        return out


class scale_by_rms(Transform):
    """`optax.scale_by_rms` with eps inside the root (the reference's
    `rmsprop_tf`) and no bias correction."""

    def init(self, param):
        return {"nu": torch.zeros_like(param)}

    def update(self, grads, params, states, step):
        out = []
        for g, s in zip(grads, states):
            s["nu"] = (1 - RMS_DECAY) * (g * g) + RMS_DECAY * s["nu"]
            out.append(torch.rsqrt(s["nu"] + RMS_EPS) * g)
        return out


class trace(Transform):
    """`optax.trace` without Nesterov: t <- g + decay t; the update is t."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, param):
        return {"trace": torch.zeros_like(param)}

    def update(self, grads, params, states, step):
        out = []
        for g, s in zip(grads, states):
            s["trace"] = g + self.decay * s["trace"]
            out.append(s["trace"])
        return out


class add_decayed_weights(Transform):
    """`optax.add_decayed_weights`: g + wd p."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, grads, params, states, step):
        return [g + self.weight_decay * p for g, p in zip(grads, params)]


class scale_by_trust_ratio(Transform):
    """`optax.scale_by_trust_ratio` with no minimum norm and eps 0: u * c
    ||p|| / ||u||, 1 where either norm is 0; the norms over a whole leaf."""

    def __init__(self, trust_coefficient: float = 1.0):
        self.trust_coefficient = trust_coefficient

    def update(self, grads, params, states, step):
        out = []
        for u, p in zip(grads, params):
            p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = self.trust_coefficient * p_norm / u_norm
            zero = (p_norm == 0.0) | (u_norm == 0.0)
            out.append(u * torch.where(zero, torch.ones_like(ratio), ratio))
        return out


class scale_by_lr(Transform):
    """`optax.scale_by_learning_rate`: -lr u, the lr read at each step (the
    counterpart of `inject_hyperparams`)."""

    def update(self, grads, params, states, step):
        return [g * -step.lr for g in grads]


def adam(weight_decay=None, nesterov=False) -> Transform:
    """`optax.adam` / `nadam`, or `adamw` / `nadamw` when a weight decay is
    given (0 included, as optax chains `add_decayed_weights(0)`)."""
    decay = () if weight_decay is None else (add_decayed_weights(weight_decay),)
    return chain(scale_by_adam(nesterov=nesterov), *decay, scale_by_lr())


def sgd(momentum) -> Transform:
    return chain(trace(momentum), scale_by_lr())


def radam() -> Transform:
    return chain(scale_by_radam(), scale_by_lr())


def adabelief(eps=1e-16) -> Transform:
    return chain(scale_by_belief(eps=eps), scale_by_lr())


def rmsprop(momentum=None) -> Transform:
    """`optax.rmsprop` at its defaults (decay 0.9, eps 1e-8 inside the root,
    initial scale 0), momentum after the lr scale."""
    return chain(scale_by_rms(), scale_by_lr(),
                 *(() if momentum is None else (trace(momentum),)))


def lamb(weight_decay=0.0) -> Transform:
    return chain(scale_by_adam(eps=1e-6), add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(), scale_by_lr())


def lars(weight_decay=0.0) -> Transform:
    """`optax.lars`: decay and trust ratio (coefficient 1e-3, eps 0) on every
    leaf (its masks default to all), then the lr, then momentum 0.9."""
    return chain(add_decayed_weights(weight_decay), scale_by_trust_ratio(trust_coefficient=0.001),
                 scale_by_lr(), trace(0.9))
