"""The port's learning-rate schedules (`catre_tpu_torch/solver/schedule.py`)
against `catre_tpu/solver/schedule.py` on a grid that holds each boundary (the
end of the warm-up, the start of annealing, the step milestones,
`total_iters - 1`, `total_iters`, and beyond it with `cyclic`), every warm-up
and anneal method, and `build_lr_fn` for the three scheduler names: every
value bit-equal. The shipped config's lr at steps 0, 999, 1000, 0.72 T and
T - 1 of a stated total T. An unknown name or method raises as in JAX.
"""

import itertools

import pytest

from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.solver import schedule as jax_schedule
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.solver import schedule

TOTAL, WARMUP = 1000, 100
# each boundary, a step either side of it, and the ends
GRID = sorted({0, 1, 2, 50, 99, 100, 101, 500, 666, 667, 668, 719, 720, 721, 888, 889, 890,
               998, 999, 1000, 1001, 1500, 2099} | set(range(0, TOTAL + 1, 37)))
WARMUPS = ("linear", "pow", "exp", "constant")
ANNEALS = ("cosine", "linear", "poly", "exp", "step", "none")


@pytest.mark.parametrize("warmup,anneal", list(itertools.product(WARMUPS, ANNEALS)))
def test_flat_and_anneal_factor_is_bit_equal(warmup, anneal):
    kw = dict(total_iters=TOTAL, warmup_iters=WARMUP, warmup_factor=1e-3, warmup_method=warmup,
              warmup_pow=1.7, anneal_point=0.72, anneal_method=anneal, target_lr_factor=0.05,
              poly_power=0.9, step_gamma=0.3, steps=(2.0 / 3.0, 8.0 / 9.0))
    for cyclic in (False, True):
        for x in GRID:
            want = jax_schedule.flat_and_anneal_factor(x, cyclic=cyclic, **kw)
            assert schedule.flat_and_anneal_factor(x, cyclic=cyclic, **kw) == want, (x, cyclic)


@pytest.mark.parametrize("warmup", ["linear", "constant"])
def test_multistep_and_warmup_cosine_factors_are_bit_equal(warmup):
    for warmup_iters in (0, WARMUP):
        for x in GRID:
            kw = dict(warmup_iters=warmup_iters, warmup_factor=1e-3, warmup_method=warmup)
            assert schedule.multistep_factor(x, TOTAL, rel_steps=(0.5, 0.75, 1.2), gamma=0.2,
                                             **kw) == jax_schedule.multistep_factor(
                x, TOTAL, rel_steps=(0.5, 0.75, 1.2), gamma=0.2, **kw), x
            assert schedule.warmup_cosine_factor(x, TOTAL, **kw) == \
                jax_schedule.warmup_cosine_factor(x, TOTAL, **kw), x


@pytest.mark.parametrize("name", ["flat_and_anneal", "WarmupMultiStepLR", "WarmupCosineLR"])
def test_build_lr_fn_is_bit_equal(name):
    cfg = {"LR_SCHEDULER_NAME": name, "BASE_LR": 2e-3, "WARMUP_ITERS": WARMUP,
           "WARMUP_FACTOR": 0.01, "ANNEAL_METHOD": "poly", "POLY_POWER": 2.0,
           "REL_STEPS": (0.3, 0.9), "GAMMA": 0.5, "TARGET_LR_FACTOR": 0.1}
    port, ref = schedule.build_lr_fn(cfg, TOTAL), jax_schedule.build_lr_fn(cfg, TOTAL)
    assert [port(x) for x in GRID] == [ref(x) for x in GRID]
    # BASE_LR absent: the optimizer's lr
    cfg = {"LR_SCHEDULER_NAME": name, "OPTIMIZER_CFG": {"lr": 3e-4}}
    port, ref = schedule.build_lr_fn(cfg, TOTAL), jax_schedule.build_lr_fn(cfg, TOTAL)
    assert [port(x) for x in GRID] == [ref(x) for x in GRID]


def test_shipped_config_lr():
    """The shipped config (Ranger at 4e-4, linear warm-up over 1000 from a
    factor of 1e-3, cosine from 0.72 T) at a total of T = 120 epochs x 1000
    iterations."""
    total = 120 * 1000
    port = schedule.build_lr_fn(dict(load_config(str(FLAGSHIP_CONFIG)).SOLVER), total)
    ref = jax_schedule.build_lr_fn(dict(jax_load_config(str(FLAGSHIP_CONFIG)).SOLVER), total)
    steps = (0, 999, 1000, int(0.72 * total), total - 1)
    got = [port(x) for x in steps]
    assert got == [ref(x) for x in steps]
    assert got[0] == 4e-4 * 1e-3 and got[2] == got[3] == 4e-4
    assert 4e-4 * 0.99 < got[1] < 4e-4 and 0 < got[4] < 4e-4 * 1e-6


def test_unknown_names_raise_as_jax():
    for mod in (schedule, jax_schedule):
        with pytest.raises(ValueError, match="Unknown LR scheduler: Poly"):
            mod.build_lr_fn({"LR_SCHEDULER_NAME": "Poly"}, TOTAL)
        with pytest.raises(ValueError, match="sqrt"):
            mod.flat_and_anneal_factor(5, TOTAL, warmup_iters=10, warmup_method="sqrt")
        with pytest.raises(ValueError, match="Unknown warmup method"):
            mod.warmup_cosine_factor(5, TOTAL, warmup_iters=10, warmup_method="exp")
