"""The port's training slice vs the JAX package on the CPU (f32):
  - K4's plain version (`rot_head_train` on a CPU tensor) vs
    `fused_rot_head_train` in interpret mode, weights x50: input and
    parameter gradients 5e-4 (rtol 1e-3), as `tests/test_pallas_vjp.py`;
  - Ranger vs JAX `ranger` over 8 steps of a fixed gradient sequence on the
    port model's converted parameters (lookahead fires at step 6,
    rectification turns on): 2e-5, as `tests/test_solver.py`; one case
    fails if the rot heads' layer-0 halves are centralised apart;
  - `step_on_prepared` vs JAX `make_train_step` with fused_heads_train, with
    and without fused_encoder_train, the batch JAX prepared, n_iter = 2, 2
    outer steps: losses rtol 2e-3, parameters 1e-3, as
    `tests/test_fused_train.py`; and the port's fused-encoder trajectory
    against its own plain-encoder trajectory at the same tolerances;
  - the config bridge's loss and noise configs, and the guards of the
    training path;
  - the optimizer a whole config builds (`optimizer_from_config`): each of
    CLIP_GRADIENTS, a head's LR_MULT and FREEZE reaches the optimizer and
    changes the first step as JAX `build_optimizer` with the runner's
    `lr_mults` / `frozen` does (1e-6); the shipped config builds Ranger.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.config.build import loss_config_from as jax_loss_config_from
from catre_tpu.config.build import noise_config_from as jax_noise_config_from
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.engine.train import InputNoiseConfig as JaxNoiseConfig
from catre_tpu.engine.train import TrainState as JaxTrainState
from catre_tpu.engine.train import make_train_step as jax_make_train_step
from catre_tpu.engine.train import prepare_train_batch as jax_prepare_train_batch
from catre_tpu.geom import axis_symmetry_rotation_bank
from catre_tpu.losses import LossConfig as JaxLossConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.models import init_params
from catre_tpu.models.heads import ConvOutPerRotHead as JaxRotHead
from catre_tpu.ops.pallas_heads_vjp import fused_rot_head_train
from catre_tpu.solver import build_optimizer as jax_build_optimizer
from catre_tpu.solver import ranger as jax_ranger
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, loss_config_from, noise_config_from
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.engine.train import (InputNoiseConfig, init_train_state, make_train_step,
                                          prepare_train_batch)
from catre_tpu_torch.entry import train_batch
from catre_tpu_torch.losses import LossConfig
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.models.heads import ConvOutPerRotHead
from catre_tpu_torch.ops import rot_head_train as train_ops
from catre_tpu_torch.solver.build import build_optimizer, optimizer_from_config
from catre_tpu_torch.solver.ranger import Ranger
from catre_tpu_torch.utils.convert import params_from_jax

from test_engine import SMALL_CFG, _synthetic_batch

P = K = 128


def _np_tree(tree, scale=1.0):
    return jax.tree_util.tree_map(lambda a: np.array(a) * scale, tree)


def _port_pair(**overrides):
    jcfg = dataclasses.replace(SMALL_CFG, **overrides)
    params = init_params(JaxModel(jcfg), jcfg, jax.random.PRNGKey(1))
    model = init_model(CATREConfig(num_pcl=P, num_kps=K, **overrides), seed=3)
    model.load_state_dict(params_from_jax(_np_tree(params), model))
    return jcfg, params, model


def _assert_params_close(params, model, atol):
    want = params_from_jax(_np_tree(params), model)
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def test_rot_head_train_plain_matches_fused_rot_head_train():
    B, NP, NK = 3, 64, 32
    rng = np.random.default_rng(91)
    pf = (rng.normal(size=(B, NP + NK, 64)) * 0.5).astype(np.float32)
    g_pcl = (rng.normal(size=(B, 1024)) * 0.5).astype(np.float32)
    g_kps = (rng.normal(size=(B, 1024)) * 0.5).astype(np.float32)
    cot = rng.normal(size=(B, 6)).astype(np.float32)
    jhead = JaxRotHead(num_points=NP + NK)
    params = jhead.init(jax.random.PRNGKey(0), *map(jnp.asarray, (pf, g_pcl, g_kps)), NP)
    params = jax.tree_util.tree_map(lambda x: x * 50.0, params["params"])

    def loss(p, pf_, gp, gk):
        return jnp.sum(fused_rot_head_train(pf_, gp, gk, p, NP, True) * cot)

    v_ref, g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        params, *map(jnp.asarray, (pf, g_pcl, g_kps)))

    head = ConvOutPerRotHead(torch.Generator().manual_seed(0), num_points=NP + NK)
    head.load_state_dict(params_from_jax(_np_tree(params), head))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (pf, g_pcl, g_kps)]
    before = train_ops.LAUNCHES["rot_head_bwd"]
    value = (train_ops.rot_head_train(*inputs, head, NP, torch.float32)
             * torch.from_numpy(cot)).sum()
    value.backward()
    assert train_ops.LAUNCHES["rot_head_bwd"] == before   # the CPU runs the plain version
    assert abs(value.item() - float(v_ref)) < 1e-3
    for t, r in zip(inputs, g_ref[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)
    want = params_from_jax(_np_tree(g_ref[0]), head)
    for name, prm in head.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("grads", ["random", "layer0_halves_offset"])
def test_ranger_matches_jax(grads):
    _, params, model = _port_pair()
    rng = np.random.default_rng(4)
    seq = []
    for _ in range(8):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), _np_tree(params))
        if grads == "layer0_halves_offset":
            # global rows and point rows of layer0 pulled apart: centralising
            # each half alone would remove both offsets, the joint mean does not
            for h in ("rot_head_x", "rot_head_y"):
                g["rot_head"][h]["layer0_kernel"][:1024] += 3.0
                g["rot_head"][h]["layer0_kernel"][1024:] -= 3.0
        seq.append(g)
    tx = jax_ranger(learning_rate=1e-2, weight_decay=0.01)
    state = tx.init(params)
    jp = params
    update = jax.jit(tx.update)
    for g in seq:
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)

    opt = Ranger(model.named_parameters(), lr=1e-2, weight_decay=0.01)
    for g in seq:
        sd = params_from_jax(g, model)
        for name, prm in model.named_parameters():
            prm.grad = sd[name].clone()
        opt.step()
    _assert_params_close(jp, model, atol=2e-5)
    slow = opt.state[model.rot_head.rot_head_x.neck.weight]["slow"]
    assert slow.data_ptr() != model.rot_head.rot_head_x.neck.weight.data_ptr()


def test_build_optimizer_is_ranger_only():
    """The shipped type builds Ranger; Adam, which the registry now has,
    builds; an unknown type raises JAX's message."""
    model = init_model(CATREConfig(num_pcl=P, num_kps=K), seed=0)
    opt = build_optimizer({"OPTIMIZER_CFG": {"type": "Ranger", "lr": 4e-4}},
                          model.named_parameters())
    assert isinstance(opt, Ranger) and opt.param_groups[0]["lr"] == 4e-4
    adam = build_optimizer({"OPTIMIZER_CFG": {"type": "Adam"}}, model.named_parameters())
    assert not isinstance(adam, Ranger) and adam.param_groups[0]["lr"] == 1e-4
    with pytest.raises(NotImplementedError) as want:
        jax_build_optimizer({"OPTIMIZER_CFG": {"type": "Adamax"}})
    with pytest.raises(NotImplementedError) as got:
        build_optimizer({"OPTIMIZER_CFG": {"type": "Adamax"}}, model.named_parameters())
    assert str(got.value) == str(want.value) == "optimizer type Adamax"


def _flagship_with(path, value, loader=load_config):
    """The shipped config, read by `loader`, with the key at `path` (a tuple
    of names) set."""
    cfg = copy.deepcopy(loader(str(FLAGSHIP_CONFIG)))
    node = cfg
    for name in path[:-1]:
        node = node[name]
    if path:
        node[path[-1]] = value
    return cfg


def _first_step(opt, named, grads):
    for name, prm in named:
        prm.grad = grads[name].clone()
    opt.step()
    return {name: prm.detach().clone() for name, prm in named}


@pytest.mark.parametrize("path,value", [
    (("SOLVER", "CLIP_GRADIENTS", "ENABLED"), True),
    (("MODEL", "CATRE", "ROT_HEAD", "LR_MULT"), 0.1),
    (("MODEL", "CATRE", "TS_HEAD", "LR_MULT"), 2.0),
    (("MODEL", "CATRE", "PCLNET", "FREEZE"), True),
    (("MODEL", "CATRE", "ROT_HEAD", "FREEZE"), True),
    (("MODEL", "CATRE", "TS_HEAD", "FREEZE"), True),
    ((), None),
], ids=lambda v: ".".join(v) if isinstance(v, tuple) and v else ("shipped" if v == () else None))
def test_unported_training_keys_raise(path, value):
    """Gradient clipping (JAX `solver/build.py:197-204`), the heads' LR
    multipliers and FREEZE (`engine/runner.py:197-205`) now reach the port's
    optimizer: the first step of `optimizer_from_config` on seeded gradients
    (x50, so that clipping by value bites) equals JAX `build_optimizer`'s with
    the runner's lr_mults / frozen, and differs from the shipped config's
    where the key acts. The shipped config builds Ranger."""
    jcfg_m, params, model = _port_pair()
    named = list(model.named_parameters())
    rng = np.random.default_rng(6)
    gtree = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 50).astype(np.float32), _np_tree(params))
    grads = params_from_jax(gtree, model)
    initial = {n: p.detach().clone() for n, p in named}

    def port_step(cfg):
        for n, p in named:
            p.data.copy_(initial[n])
        return _first_step(optimizer_from_config(cfg, model), named, grads)

    shipped = port_step(load_config(str(FLAGSHIP_CONFIG)))
    if not path:
        assert isinstance(optimizer_from_config(load_config(str(FLAGSHIP_CONFIG)), model), Ranger)
    got = port_step(_flagship_with(path, value))
    jcfg = _flagship_with(path, value, jax_load_config)
    net = jcfg.MODEL.CATRE
    lr_mults = {"rot_head": float(net.ROT_HEAD.get("LR_MULT", 1.0)),
                "ts_head": float(net.TS_HEAD.get("LR_MULT", 1.0))}
    frozen = tuple(k for k, sub in (("pcl_net", net.PCLNET), ("rot_head", net.ROT_HEAD),
                                    ("ts_head", net.TS_HEAD)) if sub.get("FREEZE", False))
    tx = jax_build_optimizer(dict(jcfg.SOLVER), lr_mults=lr_mults, frozen=frozen)
    upd, _ = jax.jit(tx.update)(jax.tree_util.tree_map(jnp.asarray, gtree), tx.init(params),
                                params)
    want = params_from_jax(_np_tree(jax.tree_util.tree_map(lambda p, u: p + u, params, upd)),
                           model)
    changed = set()
    for name, value_ in got.items():
        np.testing.assert_allclose(value_.numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        if not torch.equal(value_, shipped[name]):
            changed.add(name.split(".", 1)[0])
    if path and path[-1] == "FREEZE":
        module = {"PCLNET": "pcl_net", "ROT_HEAD": "rot_head", "TS_HEAD": "ts_head"}[path[-2]]
        assert changed == {module}
        assert all(torch.equal(got[n], initial[n]) for n in got if n.startswith(module + "."))
    elif path and path[-1] == "LR_MULT":
        assert changed == {"rot_head" if path[-2] == "ROT_HEAD" else "ts_head"}
    else:
        assert changed == (set() if not path else {"pcl_net", "rot_head", "ts_head"})


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("fused_encoder_train", [False, True])
def test_train_step_matches_jax(fused_encoder_train):
    jcfg, params, model = _port_pair(fused_heads_train=True,
                                     fused_encoder_train=fused_encoder_train)
    batch = _synthetic_batch(seed=7)   # the batch of tests/test_fused_train.py
    sym_bank = axis_symmetry_rotation_bank(max_sym_disc_step=0.1)
    jnoise = JaxNoiseConfig(bbox3d_aug_prob=0.0, rt_aug_prob=0.0)
    tx = jax_build_optimizer({"OPTIMIZER_CFG": {"type": "Ranger", "lr": 1e-3}})
    jstate = JaxTrainState(params, tx.init(params), jnp.zeros([], jnp.int32))
    jstep = jax_make_train_step(JaxModel(jcfg), jcfg, JaxLossConfig(), jnoise, tx, sym_bank,
                                n_iter=2)
    opt = build_optimizer({"OPTIMIZER_CFG": {"type": "Ranger", "lr": 1e-3}},
                          model.named_parameters())
    state = init_train_state(model, opt)
    step = make_train_step(model, LossConfig(), InputNoiseConfig(bbox3d_aug_prob=0.0,
                                                                 rt_aug_prob=0.0),
                           opt, sym_bank, n_iter=2)
    key = jax.random.PRNGKey(2)
    for _ in range(2):
        key, sub = jax.random.split(key)
        prepared = jax_prepare_train_batch(sub, dict(batch), jnoise)
        jstate, jm = jstep(jstate, dict(batch), sub, 1e-3)
        state, m = step.step_on_prepared(state, _to_torch(prepared), 1e-3)
        assert sorted(m) == sorted(jm) and m["loss_total"].shape == (2,)
        for k in ("loss_total", "loss_PM_R", "error_t"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=2e-3, err_msg=k)
    assert state.step == 2
    _assert_params_close(jstate.params, model, atol=1e-3)


def test_train_step_refuses_a_state_of_another_model_or_optimizer():
    model = init_model(CATREConfig(num_pcl=32, num_kps=32), seed=0)
    other = init_model(CATREConfig(num_pcl=32, num_kps=32), seed=0)
    opt = Ranger(model.named_parameters(), lr=1e-3)
    step = make_train_step(model, LossConfig(), InputNoiseConfig(), opt,
                           np.eye(3, dtype=np.float32)[None], n_iter=1)
    batch = prepare_train_batch(torch.Generator().manual_seed(0), train_batch(2, 32, 32, seed=0),
                                InputNoiseConfig())
    with pytest.raises(ValueError, match="parameters"):
        step.step_on_prepared(init_train_state(other, opt), batch, 1e-3)
    with pytest.raises(ValueError, match="optimizer"):
        step.step_on_prepared(init_train_state(model, Ranger(model.named_parameters())), batch,
                              1e-3)
    state, _ = step.step_on_prepared(init_train_state(model, opt), batch, 1e-3)
    assert state.step == 1


def test_prepare_train_batch_draws_from_the_generator():
    batch = train_batch(4, 64, 64, seed=1)
    noise = InputNoiseConfig(bbox3d_aug_prob=1.0, rt_aug_prob=1.0)
    a = prepare_train_batch(torch.Generator().manual_seed(5), batch, noise)
    b = prepare_train_batch(torch.Generator().manual_seed(5), batch, noise)
    for k in ("pcl", "obj_pose", "obj_scale", "obj_pose_est", "obj_scale_est"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["pcl"], batch["pcl"])               # both coins came up
    assert (a["obj_pose_est"][:, :3, 3] - a["obj_pose"][:, :3, 3]).abs().max() < 0.2
    # the random init mode, which the port now has, draws from the same generator
    rand = dataclasses.replace(noise, init_pose_types=("random",))
    c = prepare_train_batch(torch.Generator().manual_seed(5), batch, rand)
    d = prepare_train_batch(torch.Generator().manual_seed(5), batch, rand)
    torch.testing.assert_close(c["obj_pose_est"], d["obj_pose_est"], rtol=0, atol=0)
    t = c["obj_pose_est"][:, :3, 3]
    assert (t[:, 2] >= 0.5).all() and (t[:, 2] <= 1.3).all() and (t[:, :2].abs() <= 0.35).all()


@pytest.mark.parametrize("name", ["", "_initspd", "_tpu"])
def test_loss_and_noise_configs_match_jax(name):
    path = str(FLAGSHIP_CONFIG).replace("_tpu.py", f"{name}.py")
    port_cfg, jax_cfg = load_config(path), jax_load_config(path)
    assert dataclasses.asdict(loss_config_from(port_cfg)) == dataclasses.asdict(
        jax_loss_config_from(jax_cfg))
    port_noise = dataclasses.asdict(noise_config_from(port_cfg))
    jax_noise = dataclasses.asdict(jax_noise_config_from(jax_cfg))
    assert port_noise == {k: jax_noise[k] for k in port_noise}


def _port_trajectory(batch, steps, **overrides):
    """`steps` outer steps (n_iter = 2) of a seeded small port model on a
    prepared batch -> (mean loss per step, parameters)."""
    model = init_model(CATREConfig(num_pcl=P, num_kps=K, **overrides), seed=3)
    opt = build_optimizer({"OPTIMIZER_CFG": {"type": "Ranger", "lr": 1e-3}},
                          model.named_parameters())
    noise = InputNoiseConfig(bbox3d_aug_prob=0.0, rt_aug_prob=0.0)
    step = make_train_step(model, LossConfig(), noise, opt,
                           axis_symmetry_rotation_bank(max_sym_disc_step=0.1), n_iter=2)
    state = init_train_state(model, opt)
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(steps):
        state, m = step.step_on_prepared(state, prepare_train_batch(gen, batch, noise), 1e-3)
        losses.append(m["loss_total"].mean().item())
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def test_fused_encoder_train_matches_the_plain_encoder():
    batch = _to_torch(_synthetic_batch(seed=9))   # the batch of tests/test_fused_train.py:61
    plain = _port_trajectory(batch, 3, fused_heads_train=True)
    fused = _port_trajectory(batch, 3, fused_heads_train=True, fused_encoder_train=True)
    np.testing.assert_allclose(fused[0], plain[0], rtol=2e-3)
    for name, prm in plain[1].items():
        np.testing.assert_allclose(fused[1][name].numpy(), prm.numpy(), atol=1e-3, err_msg=name)


def test_fused_encoder_train_trains_in_a_training_call():
    from catre_tpu_torch import ops

    model = init_model(CATREConfig(num_pcl=32, num_kps=32, fused_heads_train=True,
                                   fused_encoder_train=True), seed=0)
    args = (torch.randn(2, 32, 3) * 0.1, torch.randn(2, 32, 3) * 0.1, torch.full((2, 3), 0.2),
            torch.zeros(2, 3))
    ops.reset_launch_counts()
    sum(o.sum() for o in model(*args)).backward()
    enc = model.pcl_net
    for layer in (enc.stn.conv3, enc.fstn.conv3, enc.conv3, enc.conv4):
        assert layer.weight.grad is not None and layer.weight.grad.abs().sum() > 0
        assert layer.bias.grad is not None and torch.isfinite(layer.bias.grad).all()
    assert not any(ops.launch_counts().values())     # on the CPU the plain versions ran
    with torch.no_grad():
        model(*args)    # an inference call takes the inference tails
    plain = init_model(CATREConfig(num_pcl=32, num_kps=32, fused_encoder_train=True), seed=0)
    assert not plain.cfg.uses_tail_train_kernels     # rides fused_heads_train, as in the JAX package


def test_inference_kernel_guard_raises_on_a_differentiable_cpu_tensor():
    from catre_tpu_torch.ops import _build

    w = torch.randn(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad.*Training takes the plain"):
        _build.refuse_grad("dense_relu_max", "the plain encoder", torch.randn(2), w)
    _build.refuse_grad("dense_relu_max", "the plain encoder", torch.randn(2), w.detach())
    with torch.no_grad():
        _build.refuse_grad("dense_relu_max", "the plain encoder", w)
