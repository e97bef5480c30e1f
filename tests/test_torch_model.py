"""The port's model and refine slice vs the JAX package on the CPU:
  - the delta model vs `CATREDisRShared.apply`, plain and kernel (twin) paths: 2e-4;
  - the 2-iteration refine vs JAX `make_refine_fn` with fused_heads=True: 5e-4;
  - `params_from_jax` consumes every leaf and fills every parameter;
  - the config bridge reads the shipped configs as the JAX package does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.config.build import model_config_from as jax_model_config_from
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.engine.refiner import make_refine_fn as jax_make_refine_fn
from catre_tpu.models import CATREConfig as JaxConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.models import init_params
from catre_tpu_torch.config.build import CONFIG_DIR, FLAGSHIP_CONFIG, model_config_from
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.engine.refiner import make_refine_fn
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.utils.convert import params_from_jax

from test_engine import _synthetic_batch

P = K = 128


def _pair(**overrides):
    """JAX params and a port model holding the same weights."""
    jcfg = JaxConfig(num_pcl=P, num_kps=K, **overrides)
    jmodel = JaxModel(jcfg)
    params = init_params(jmodel, jcfg, jax.random.PRNGKey(0))
    cfg = CATREConfig(num_pcl=P, num_kps=K, **overrides)
    model = init_model(cfg, seed=1)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.array, params), model))
    return jcfg, jmodel, params, cfg, model


def _inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, P, 3)) * 0.2).astype(np.float32),
            (rng.normal(size=(b, K, 3)) * 0.2).astype(np.float32),
            rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32),
            rng.normal(size=(b, 3)).astype(np.float32)]


@pytest.mark.parametrize("overrides", [
    {},                                                          # shipped model config
    {"ts_with_kps_feature": True, "ts_with_init_trans": True},
    {"rot_type": "allo_quat", "feature_transform": False},
    {"rot_type": "ego_lie_vec"},                                 # odd width: 2 + 1 heads
])
@pytest.mark.parametrize("fused", [False, True])
def test_delta_model_matches_flax(overrides, fused):
    _, jmodel, params, cfg, model = _pair(**overrides)
    model.cfg = dataclasses.replace(cfg, fused_heads=fused)
    xs = _inputs(7)
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, xs))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, xs))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4, rtol=0)


def test_refine_matches_jax_fused_refine():
    jcfg, jmodel, params, cfg, model = _pair(fused_heads=True)
    batch = _synthetic_batch(b=4, p=P, k=K, seed=5)
    names = ("pcl", "obj_kps", "obj_pose", "obj_scale", "K", "obj_mean_scales")
    poses_ref, scales_ref = jax_make_refine_fn(jmodel, jcfg, n_iter=2)(
        params, *(batch[n] for n in names))
    poses, scales = make_refine_fn(model, n_iter=2)(
        *(torch.from_numpy(np.array(batch[n])) for n in names))
    assert poses.shape == (3, 4, 3, 4) and scales.shape == (3, 4, 3)
    np.testing.assert_allclose(poses.numpy(), np.asarray(poses_ref), atol=5e-4, rtol=0)
    np.testing.assert_allclose(scales.numpy(), np.asarray(scales_ref), atol=5e-4, rtol=0)


def test_refine_unequal_point_counts():
    """Separate encoder calls when P != K, plain and kernel paths agree."""
    cfg = CATREConfig(num_pcl=96, num_kps=64, fused_heads=True)
    model = init_model(cfg, seed=3)
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in (
        (rng.normal(size=(2, 96, 3)) * 0.1 + [0, 0, 1]).astype(np.float32),
        (rng.normal(size=(2, 64, 3)) * 0.3).astype(np.float32),
        np.tile(np.concatenate([np.eye(3), [[0], [0], [1.0]]], 1), (2, 1, 1)).astype(np.float32),
        rng.uniform(0.1, 0.3, size=(2, 3)).astype(np.float32),
        np.tile(np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]], np.float32),
                (2, 1, 1)))]
    fused = make_refine_fn(model, n_iter=2)(*args)
    model.cfg = dataclasses.replace(cfg, fused_heads=False)
    plain = make_refine_fn(model, n_iter=2)(*args)
    for a, b in zip(fused, plain):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=0)


def test_params_from_jax_consumes_every_leaf():
    _, _, params, _, model = _pair()
    tree = jax.tree_util.tree_map(np.array, params)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    sd = params_from_jax(tree, model)
    assert set(sd) == set(model.state_dict())
    # each rot head's layer0_kernel fills two port parameters
    assert len(sd) == n_leaves + 2
    np.testing.assert_array_equal(
        sd["rot_head.rot_head_x.layer0_global_weight"].numpy(),
        tree["rot_head"]["rot_head_x"]["layer0_kernel"][:1024].T)
    np.testing.assert_array_equal(sd["pcl_net.conv4.weight"].numpy(),
                                  tree["pcl_net"]["conv4"]["Dense_0"]["kernel"].T)


@pytest.mark.parametrize("break_tree", ["extra_leaf", "missing_leaf", "bad_shape"])
def test_params_from_jax_raises(break_tree):
    _, _, params, _, model = _pair()
    tree = jax.tree_util.tree_map(np.array, params)
    if break_tree == "extra_leaf":
        tree["ts_head"]["stray"] = np.zeros(3, np.float32)
    elif break_tree == "missing_leaf":
        del tree["rot_head"]["rot_head_y"]["point_bias_param"]
    else:
        tree["pcl_net"]["conv1"]["Dense_0"]["bias"] = np.zeros(65, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tree, model)


@pytest.mark.parametrize("name", sorted(p.name for p in (CONFIG_DIR / "nocs_real").glob("*.py")))
def test_model_config_matches_jax(name):
    path = str(CONFIG_DIR / "nocs_real" / name)
    assert load_config(path) == jax_load_config(path)
    port, ref = model_config_from(load_config(path)), jax_model_config_from(jax_load_config(path))
    for field in dataclasses.fields(port):
        want = getattr(ref, field.name)
        if field.name == "dtype":
            assert (port.dtype is None) == (want is None)
        else:
            assert getattr(port, field.name) == want, field.name


def test_flagship_config_is_production():
    cfg = model_config_from(load_config(str(FLAGSHIP_CONFIG)))
    assert cfg.dtype == torch.bfloat16 and cfg.uses_rot_head_kernel and cfg.uses_tail_kernels
    assert cfg.fused_heads_train and cfg.fused_encoder_train and cfg.uses_tail_train_kernels
    assert (cfg.num_pcl, cfg.num_kps, cfg.pclnet_out_dim) == (1024, 1024, 1024)


def test_fused_heads_need_rot6d(caplog):
    cfg = load_config(str(FLAGSHIP_CONFIG))
    cfg.MODEL.CATRE.ROT_HEAD.ROT_TYPE = "ego_quat"
    cfg.MODEL.CATRE.ROT_HEAD.INIT_CFG.rot_dim = 2
    port = model_config_from(cfg)
    assert not port.fused_heads and not port.uses_tail_kernels
    assert "rot6d only" in caplog.text
