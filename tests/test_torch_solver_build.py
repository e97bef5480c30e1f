"""What `catre_tpu_torch/solver/build.py::build_optimizer` adds around an
optimizer type, against JAX `catre_tpu/solver/build.py::build_optimizer` on
the CPU, over 8 steps (a Lookahead sync falls inside) with the lr changed
between steps, on the parameter set of `test_torch_solver_registry.py`
(parameters within 2e-5):
  - gradient clipping by value, by norm and by full_model (one global norm),
    triggered and not;
  - LR_MULT and FREEZE on the final change: a frozen parameter is bit-unchanged
    while its moments and its Lookahead slow copy advance;
  - a CLIP_TYPE that JAX ignores raises;
  - checkpoints: ranger21 and lookahead(adam) saved at step 4 and resumed follow
    an unbroken 8-step run bit for bit;
  - one whole train step (2 inner iterations) against JAX `make_train_step`
    with adamw, clipping, LR_MULT, FREEZE and the canonical init, with the
    "_vis" payload: losses rtol 2e-3 (as
    `test_torch_train.py::test_train_step_matches_jax`), the first
    iteration's predictions 5e-4 (the f32 refine's tolerance), frozen
    parameters bit-unchanged, and every other parameter's change within 3e-2
    of JAX's in norm, the second iteration's predictions within 5e-3. Adam's
    first update of an element is lr g / (|g| + eps), about lr whatever the
    gradient's size, so where |g| is near the two packages' float32 gradient
    difference (or a max-pool row is routed the other way at a near tie) the
    updates part by up to lr: measured up to 1.2e-2 of a parameter's change
    in norm at lr 1e-3 and 1e-4 alike. The 1e-3 elementwise bound of the
    Ranger test holds for Ranger's first, unrectified steps, lr x gradient.
    The trajectory tests above hold the optimizers themselves to 2e-5 on
    identical gradients. JAX's step sets the
    lr on `opt_state.hyperparams` (`engine/train.py::_set_lr`), which
    `optax.chain(clip, tx)`'s tuple state does not have (ROADMAP queue 3), so
    there the same clip runs first inside the injected state's update.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from catre_tpu.engine.train import InputNoiseConfig as JaxNoiseConfig
from catre_tpu.engine.train import TrainState as JaxTrainState
from catre_tpu.engine.train import make_train_step as jax_make_train_step
from catre_tpu.engine.train import prepare_train_batch as jax_prepare_train_batch
from catre_tpu.geom import axis_symmetry_rotation_bank
from catre_tpu.losses import LossConfig as JaxLossConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.solver import build_optimizer as jax_build_optimizer
from catre_tpu_torch.engine.train import InputNoiseConfig, init_train_state, make_train_step
from catre_tpu_torch.engine.train import prepare_train_batch
from catre_tpu_torch.losses import LossConfig
from catre_tpu_torch.solver.build import build_optimizer
from catre_tpu_torch.utils import checkpoint as ck
from catre_tpu_torch.utils.convert import params_from_jax

from test_engine import _synthetic_batch
from test_torch_solver_registry import (_flax_params, assert_close, gradient_sequence,
                                        jax_trajectory, port_trajectory, small_module)
from test_torch_train import _port_pair, _to_torch

STEPS = 8
LRS = [1e-2, 1e-2, 5e-3, 5e-3, 2e-2, 1e-2, 1e-2, 3e-3]


def _run(solver_cfg, lr_mults=None, frozen=()):
    params = _flax_params(np.random.default_rng(0))
    seq = gradient_sequence(params, STEPS)
    want = jax_trajectory(solver_cfg, params, seq, lr_mults, frozen, LRS)
    module = small_module(params)
    initial = {n: p.detach().clone() for n, p in module.named_parameters()}
    opt = build_optimizer(solver_cfg, module.named_parameters(), lr_mults, frozen)
    got = port_trajectory(opt, module, seq, LRS)
    for i in range(STEPS):
        assert_close(want[i], module, got[i], what=f"step {i + 1}")
    return module, opt, initial, got


@pytest.mark.parametrize("clip_type,clip_value", [
    ("value", 0.5), ("norm", 3.0), ("full_model", 3.0), ("norm", 1e4),   # the last never clips
])
@pytest.mark.parametrize("typ", ["ranger", "adamw"])
def test_clipping_follows_jax(typ, clip_type, clip_value):
    cfg = {"OPTIMIZER_CFG": {"type": typ, "lr": 1e-2, "weight_decay": 0.01},
           "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": clip_type, "CLIP_VALUE": clip_value}}
    _, opt, _, _ = _run(cfg)
    assert opt.clip == (clip_type, clip_value)


@pytest.mark.parametrize("opt_cfg,slow_key,moment_key", [
    ({"type": "Ranger", "weight_decay": 0.01}, "slow", "exp_avg"),
    ({"type": "lookahead", "k": 3, "inner": {"type": "adamw", "weight_decay": 0.01}},
     "slow", "mu"),
    ({"type": "sgd_gc", "weight_decay": 0.01}, None, "trace"),
])
def test_lr_mult_and_freeze_scale_the_final_change(opt_cfg, slow_key, moment_key):
    cfg = {"OPTIMIZER_CFG": dict(opt_cfg, lr=1e-2)}
    module, opt, initial, got = _run(cfg, lr_mults={"rot_head": 0.5, "ts_head": 3.0},
                                     frozen=("ts_head",))
    named = dict(module.named_parameters())
    for name, value in got[-1].items():
        if name.startswith("ts_head."):
            assert torch.equal(value, initial[name]), name           # bit-unchanged
            state = opt.state[named[name]]
            assert state[moment_key].abs().max() > 0                  # its moments moved
            if slow_key is not None:                                  # and its slow copy
                assert not torch.equal(state[slow_key], initial[name])
        else:
            assert not torch.equal(value, initial[name]), name
    assert opt.mults == {p: (0.0 if n.startswith("ts_head.") else 0.5)
                         for n, p in named.items() if not n.startswith("pcl_net.")}


def test_unknown_clip_type_raises():
    module = small_module(_flax_params(np.random.default_rng(0)))
    cfg = {"OPTIMIZER_CFG": {"type": "adam", "lr": 1e-3},
           "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "agc", "CLIP_VALUE": 1.0}}
    jax_build_optimizer(cfg)      # the JAX package ignores it without a word
    with pytest.raises(ValueError, match="CLIP_TYPE = 'agc'"):
        build_optimizer(cfg, module.named_parameters())


@pytest.mark.parametrize("opt_cfg", [
    {"type": "ranger21", "lr": 1e-2},
    {"type": "lookahead", "k": 3, "lr": 1e-2, "inner": {"type": "adam"}},
])
def test_checkpoint_resumes_bit_for_bit(opt_cfg, tmp_path):
    solver = {"OPTIMIZER_CFG": opt_cfg, "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "norm",
                                                           "CLIP_VALUE": 3.0}}
    params = _flax_params(np.random.default_rng(0))
    seq = gradient_sequence(params, STEPS)

    def fresh():
        module = small_module(params)
        return module, build_optimizer(solver, module.named_parameters(), {"rot_head": 0.5})

    module, opt = fresh()
    unbroken = port_trajectory(opt, module, seq, LRS)
    module, opt = fresh()
    port_trajectory(opt, module, seq[:4], LRS[:4])
    ck.save_checkpoint(str(tmp_path), 4, {"model": module, "optimizer": opt})
    module, opt = fresh()
    got = ck.load_checkpoint(str(tmp_path))
    module.load_state_dict(got["model"])
    opt.load_state_dict(got["optimizer"])
    resumed = port_trajectory(opt, module, seq[4:], LRS[4:])
    for step, (a, b) in enumerate(zip(unbroken[4:], resumed), 5):
        for name in a:
            assert torch.equal(a[name], b[name]), (step, name)


def test_train_step_with_the_solver_and_canonical_init_matches_jax():
    jcfg, params, model = _port_pair(fused_heads_train=True)
    batch = _synthetic_batch(seed=7)
    sym_bank = axis_symmetry_rotation_bank(max_sym_disc_step=0.1)
    solver = {"OPTIMIZER_CFG": {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.01},
              "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "norm", "CLIP_VALUE": 1.0}}
    mults, frozen = {"rot_head": 0.5}, ("ts_head",)
    modes = dict(bbox3d_aug_prob=0.0, rt_aug_prob=0.0, init_pose_types=("canonical",),
                 init_scale_types=("canonical",))
    jnoise = JaxNoiseConfig(**modes)
    inner = jax_build_optimizer(dict(solver, CLIP_GRADIENTS={}), lr_mults=mults, frozen=frozen)
    clip = optax.clip_by_global_norm(1.0)
    tx = optax.GradientTransformation(
        inner.init, lambda g, s, p: inner.update(clip.update(g, clip.init(p))[0], s, p))
    jstate = JaxTrainState(params, tx.init(params), jnp.zeros([], jnp.int32))
    jstep = jax_make_train_step(JaxModel(jcfg), jcfg, JaxLossConfig(), jnoise, tx, sym_bank,
                                n_iter=2, with_vis=True)
    opt = build_optimizer(solver, model.named_parameters(), mults, frozen)
    noise = InputNoiseConfig(**modes)
    step = make_train_step(model, LossConfig(), noise, opt, sym_bank, n_iter=2, with_vis=True)
    ts_before = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n.startswith("ts_head.")}
    key = jax.random.PRNGKey(2)
    jprepared = jax_prepare_train_batch(key, dict(batch), jnoise)
    prepared = prepare_train_batch(torch.Generator().manual_seed(0), _to_torch(batch), noise)
    for k in ("obj_pose_est", "obj_scale_est"):
        np.testing.assert_allclose(prepared[k].numpy(), np.asarray(jprepared[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    before = params_from_jax(jax.tree_util.tree_map(np.array, params), model)  # jstep donates
    jstate, jm = jstep(jstate, dict(batch), key, 1e-3)
    _, m = step.step_on_prepared(init_train_state(model, opt), prepared, 1e-3)
    for k in ("loss_total", "loss_PM_R", "error_t"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=2e-3, err_msg=k)
    assert sorted(m["_vis"]) == sorted(jm["_vis"])
    for k, v in m["_vis"].items():
        want_vis = np.asarray(jm["_vis"][k])
        assert v.shape == want_vis.shape, k
        if k in ("pose", "scale"):
            np.testing.assert_allclose(v[0].numpy(), want_vis[0], atol=5e-4, err_msg=k)
            np.testing.assert_allclose(v[1].numpy(), want_vis[1], atol=5e-3, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want_vis, atol=1e-6, err_msg=k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), model)
    for n, p in model.named_parameters():
        if n.startswith("ts_head."):
            assert torch.equal(p, ts_before[n]) and torch.equal(want[n], before[n]), n
            continue
        d_want, d_got = want[n] - before[n], p.detach() - before[n]
        assert (d_got - d_want).norm() <= 3e-2 * d_want.norm(), n
