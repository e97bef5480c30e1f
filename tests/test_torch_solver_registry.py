"""Every optimizer type of the port's registry (`catre_tpu_torch/solver/build.py`)
against JAX `catre_tpu/solver/build.py::build_optimizer` on the CPU: 15 steps of
one seeded gradient sequence on a parameter set in the port's layout (a conv
weight and bias, a rotation head's `point_weight`, its layer-0 pair
`layer0_global_weight` / `layer0_point_weight`, a TS-head weight), converted
from the flax tree by `utils/convert.py::params_from_jax`; parameters within
2e-5 (the tolerance of `test_ranger_matches_jax`). The gradient sequence pulls
the two layer-0 halves apart, so an optimizer that computes a per-leaf
quantity per half fails. AdamP / SGDP's projection over the joined layer-0
leaf equals JAX's `_projection` over the flax leaf (1e-6), where per half it
would not. An unknown type raises JAX's message.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from catre_tpu.solver import build_optimizer as jax_build_optimizer
from catre_tpu.solver.extra import _projection as jax_projection
from catre_tpu_torch.solver import extra
from catre_tpu_torch.solver.build import OPTIMIZER_TYPES, build_optimizer
from catre_tpu_torch.solver.optimizer import PortOptimizer, leaf_groups
from catre_tpu_torch.utils.convert import params_from_jax

STEPS, LR, TOL = 15, 1e-2, 2e-5

# one case per registry name at its defaults, then variants (some replace a name's case)
CASES = {name: {"type": name} for name in OPTIMIZER_TYPES}
CASES.update({
    # weight decay through the types that take one
    "adam_wd": {"type": "Adam", "weight_decay": 0.01},
    "adamw": {"type": "AdamW", "weight_decay": 0.01},
    "nadamw": {"type": "nadamw", "weight_decay": 0.01},
    "lamb_wd": {"type": "lamb", "weight_decay": 0.01},
    "lars_wd": {"type": "lars", "weight_decay": 0.01},
    "ralamb": {"type": "ralamb", "weight_decay": 0.01},
    "over9000": {"type": "over9000", "weight_decay": 0.01},
    "rangerlars": {"type": "RangerLars", "k": 4, "alpha": 0.6},
    "madgrad_wd": {"type": "madgrad", "weight_decay": 0.01, "momentum": 0.8},
    "adamp_wd": {"type": "AdamP", "weight_decay": 0.01},
    "sgdp_wd": {"type": "SGDP", "weight_decay": 0.01},
    "sgd_gc": {"type": "SGD_GC", "weight_decay": 0.01},
    "ranger_wd": {"type": "Ranger", "weight_decay": 0.01},
    "ranger2020": {"type": "ranger2020", "weight_decay": 0.01},
    "ranger2020_gc_grad": {"type": "ranger2020", "weight_decay": 0.01, "gc_loc": False},
    "ranger2020_gc_conv_only": {"type": "ranger2020", "gc_conv_only": True},
    "ranger_adabelief": {"type": "ranger_adabelief", "weight_decay": 0.01},
    "ranger_adabelief_coupled": {"type": "ranger_adabelief", "weight_decay": 0.01,
                                 "weight_decouple": False},
    "rmsprop_momentum": {"type": "rmsprop", "momentum": 0.9},
    # badam's and ranger21's weight decay default only when the key is absent
    "badam_wd0": {"type": "BAdam", "weight_decay": 0.0},
    "ranger21_wd0": {"type": "ranger21", "weight_decay": 0.0},
    "ranger21_no_la": {"type": "ranger21", "lookahead_mergetime": 100, "normloss_active": False},
    "lookahead": {"type": "lookahead", "k": 5},
    "lookahead_adamw": {"type": "Lookahead", "k": 4, "alpha": 0.3,
                        "inner": {"type": "adamw", "weight_decay": 0.01}},
    "lookahead_ranger": {"type": "lookahead", "k": 5, "inner": {"type": "ranger"}},
})


def _flax_params(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32) * 0.5  # noqa: E731
    return {
        "pcl_net": {"conv1": {"Dense_0": {"kernel": f(6, 8), "bias": f(8)}}},
        "rot_head": {"rot_head_x": {"layer0_kernel": f(76, 12), "layer0_bias": f(12),
                                    "point_weight": f(24)}},
        "ts_head": {"fc_t": {"Dense_0": {"kernel": f(12, 3), "bias": f(3)}}},
    }


def small_module(params) -> nn.Module:
    """A module whose parameters carry the port's names and layout for the
    flax tree `params`."""
    root = nn.Module()
    for path in ("pcl_net.conv1", "rot_head.rot_head_x", "ts_head.fc_t"):
        node = root
        for name in path.split("."):
            if not hasattr(node, name):
                setattr(node, name, nn.Module())
            node = getattr(node, name)
    x = params["rot_head"]["rot_head_x"]
    k = x["layer0_kernel"]
    shapes = {
        "pcl_net.conv1.weight": (8, 6), "pcl_net.conv1.bias": (8,),
        "rot_head.rot_head_x.layer0_global_weight": (k.shape[1], k.shape[0] - 64),
        "rot_head.rot_head_x.layer0_point_weight": (k.shape[1], 64),
        "rot_head.rot_head_x.layer0_bias": x["layer0_bias"].shape,
        "rot_head.rot_head_x.point_weight": x["point_weight"].shape,
        "ts_head.fc_t.weight": (3, 12), "ts_head.fc_t.bias": (3,),
    }
    for name, shape in shapes.items():
        *mods, leaf = name.split(".")
        node = root
        for m in mods:
            node = getattr(node, m)
        setattr(node, leaf, nn.Parameter(torch.zeros(shape)))
    root.load_state_dict(params_from_jax(params, root))
    return root


def gradient_sequence(params, steps=STEPS, seed=4):
    """Seeded gradients, the layer-0 kernel's global rows and point rows
    pulled apart (centralised or normed per half, they would differ)."""
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(steps):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        k = g["rot_head"]["rot_head_x"]["layer0_kernel"]
        k[:-64] += 2.0
        k[-64:] -= 3.0
        seq.append(g)
    return seq


def jax_trajectory(solver_cfg, params, seq, lr_mults=None, frozen=(), lrs=None):
    """-> the flax parameters after each step of JAX `build_optimizer`, its
    update jitted as the JAX train step runs it (XLA's float32 `b2 ** count`
    in a jit is powf's, not the eager op's). With clipping the state is
    `optax.chain`'s tuple (clip, injected): the lr is set on the second."""
    from catre_tpu.engine.train import _set_lr

    tx = jax_build_optimizer(solver_cfg, lr_mults=lr_mults, frozen=frozen)
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for i, g in enumerate(seq):
        if lrs is not None:
            state = (_set_lr(state, lrs[i]) if hasattr(state, "hyperparams")
                     else (state[0], _set_lr(state[1], lrs[i])))
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        out.append(params)
    return out


def port_trajectory(opt, module, seq, lrs=None):
    out = []
    for i, g in enumerate(seq):
        if lrs is not None:
            for group in opt.param_groups:
                group["lr"] = lrs[i]
        sd = params_from_jax(g, module)
        for name, prm in module.named_parameters():
            prm.grad = sd[name].clone()
        opt.step()
        out.append({n: p.detach().clone() for n, p in module.named_parameters()})
    return out


def assert_close(jax_params, module, got, tol=TOL, what=""):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), module)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=tol, rtol=0,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_type_follows_the_jax_trajectory(case):
    opt_cfg = dict(CASES[case], lr=LR)
    params = _flax_params(np.random.default_rng(0))
    seq = gradient_sequence(params)
    want = jax_trajectory({"OPTIMIZER_CFG": opt_cfg}, params, seq)
    module = small_module(params)
    opt = build_optimizer({"OPTIMIZER_CFG": opt_cfg}, module.named_parameters())
    assert isinstance(opt, PortOptimizer) and opt.param_groups[0]["lr"] == LR
    got = port_trajectory(opt, module, seq)
    for i in (0, 4, 5, 6, STEPS - 1):
        assert_close(want[i], module, got[i], what=f"{case} step {i + 1}")


def test_the_layer0_pair_is_one_leaf():
    params = _flax_params(np.random.default_rng(0))
    module = small_module(params)
    leaves = leaf_groups(module.named_parameters())
    names = [name for name, _ in leaves]
    assert names == ["weight", "bias", "layer0_kernel", "layer0_bias", "point_weight", "weight",
                     "bias"]
    assert [p.shape for p in leaves[2][1]] == [(12, 12), (12, 64)]


@pytest.mark.parametrize("on_scale", [True, False])
def test_projection_over_the_joined_layer0_leaf(on_scale):
    """A step direction orthogonal to the whole flax leaf (76, 12) is on the
    scale direction and loses the leaf's radial part; projected per half it
    would lose each half's."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(76, 12)).astype(np.float32)
    d = rng.normal(size=p.shape).astype(np.float32)
    if on_scale:
        d = (d - (d * p).sum() / (p * p).sum() * p).astype(np.float32)
    want, want_ratio = jax_projection(0.1, 0.1)(jnp.asarray(p), jnp.asarray(d))
    project = extra._projected(None, 0.0).project
    got, ratio = project(torch.from_numpy(p.T.copy()), torch.from_numpy(d.T.copy()))
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), atol=1e-6, rtol=0)
    assert float(ratio) == float(want_ratio) == float(np.float32(0.1 if on_scale else 1.0))
    halves = np.concatenate([
        project(torch.from_numpy(p[sl].T.copy()), torch.from_numpy(d[sl].T.copy()))[0].numpy().T
        for sl in (slice(0, 12), slice(12, 76))])
    if on_scale:
        assert np.abs(halves - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("typ", ["NoSuchOptimizer", "adamax"])
def test_unknown_type_raises_as_jax(typ):
    module = small_module(_flax_params(np.random.default_rng(0)))
    cfg = {"OPTIMIZER_CFG": {"type": typ, "lr": 1e-3}}
    with pytest.raises(NotImplementedError) as want:
        jax_build_optimizer(cfg)
    with pytest.raises(NotImplementedError) as got:
        build_optimizer(cfg, module.named_parameters())
    assert str(got.value) == str(want.value) == f"optimizer type {typ}"
