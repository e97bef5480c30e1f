"""bf16 results of the port against bf16 results of the JAX package, on the CPU.

Every other comparison with the JAX package is f32. Here the plain port model
with `dtype=torch.bfloat16` and every fused flag off runs beside flax
`CATREDisRShared` with `dtype=jnp.bfloat16`, on the same weights (through
`params_from_jax`) and the same numpy inputs, B = 4, 128 + 128 points: one
delta forward, and a 2-iteration refine.

Tolerance. bf16 keeps 8 significant bits: neighbouring bf16 numbers of
magnitude m lie between 2^-8 m and 2^-7 m apart ("a spacing" below is
2^-7 m). Both packages round at the same places (after every Dense, flax's
`Dense(dtype=bf16)` and the port's `dense`), but sum their f32 products in
different orders, and where two sums straddle a rounding boundary the rounded
activations differ by one spacing. The compared tensors are some 15 roundings
deep (input cast, 3 STN + 4 trunk encoder layers twice over with the feature
transform, the heads' layers, the neck), and the head outputs are bf16
numbers themselves, so they can only differ by whole spacings. Held: 3
spacings of the largest value in the tensor. Measured on this CPU: rotation
deltas 1 spacing (2.4e-6 at max 2.4e-4), translation deltas 1 (9.8e-4 at
0.161), scale deltas 1.5 (1.5e-3 at 0.150); JAX in bf16 lies as far from JAX
in f32 (3.1e-6, 8.9e-4, 1.6e-3).

The refine turns the rot6d deltas into matrices by normalising them, so a
rotation entry (magnitude 1) inherits the relative error of a delta: held to
3 spacings of 1.0 = 2.3e-2 after two iterations (measured 1.2e-2, JAX bf16
from JAX f32 9.0e-3); translations and scales to 3 spacings of their largest
value (measured 3.6e-4 at 0.98 and 1.7e-3 at 0.21).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.engine.refiner import make_refine_fn as jax_make_refine_fn
from catre_tpu.models import CATREConfig as JaxConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.models import init_params
from catre_tpu_torch.engine.refiner import make_refine_fn
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.utils.convert import params_from_jax

from test_engine import _synthetic_batch

P = K = 128
B = 4
SPACING = 2.0 ** -7      # of neighbouring bf16 numbers, relative, at most
PLAIN = dict(fused_heads=False, fused_encoder_epilogue=False, fused_heads_train=False,
             fused_encoder_train=False)


@pytest.fixture(scope="module")
def pair():
    """flax model and params in bf16 (and the f32 config), the port model in
    bf16 holding the same weights; every fused flag off."""
    jcfg = JaxConfig(num_pcl=P, num_kps=K, dtype=jnp.bfloat16, **PLAIN)
    jmodel = JaxModel(jcfg)
    params = init_params(jmodel, jcfg, jax.random.PRNGKey(0))
    cfg = CATREConfig(num_pcl=P, num_kps=K, dtype=torch.bfloat16, **PLAIN)
    model = init_model(cfg, seed=1)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.array, params), model))
    return jcfg, jmodel, params, model


def _held(name, out, ref, spacings=3.0, scale=None):
    out, ref = np.asarray(out, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    limit = spacings * SPACING * (np.abs(ref).max() if scale is None else scale)
    err = np.abs(out - ref).max()
    assert err <= limit, f"{name}: {err} > {limit}"
    return err


def test_bf16_delta_forward_matches_flax_bf16(pair):
    jcfg, jmodel, params, model = pair
    rng = np.random.default_rng(7)
    xs = [(rng.normal(size=(B, P, 3)) * 0.2).astype(np.float32),
          (rng.normal(size=(B, K, 3)) * 0.2).astype(np.float32),
          rng.uniform(0.1, 0.3, size=(B, 3)).astype(np.float32),
          rng.normal(size=(B, 3)).astype(np.float32)]
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, xs))
    jcfg32 = dataclasses.replace(jcfg, dtype=None)
    ref32 = JaxModel(jcfg32).apply({"params": params}, *map(jnp.asarray, xs))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, xs))
    for name, o, r, r32 in zip(("rot", "trans", "scale"), out, ref, ref32):
        assert o.dtype == torch.float32
        _held(f"{name} deltas", o.numpy(), r)
        # the comparison is of bf16 with bf16: flax in bf16 is not flax in f32
        assert np.abs(np.asarray(r, np.float32) - np.asarray(r32)).max() > 0


def test_bf16_refine_matches_jax_bf16(pair):
    jcfg, jmodel, params, model = pair
    batch = _synthetic_batch(b=B, p=P, k=K, seed=5)
    names = ("pcl", "obj_kps", "obj_pose", "obj_scale", "K", "obj_mean_scales")
    poses_ref, scales_ref = jax_make_refine_fn(jmodel, jcfg, n_iter=2)(
        params, *(batch[n] for n in names))
    with torch.no_grad():
        poses, scales = make_refine_fn(model, n_iter=2)(
            *(torch.from_numpy(np.array(batch[n])) for n in names))
    poses_ref, poses = np.asarray(poses_ref), poses.numpy()
    assert poses.shape == (3, B, 3, 4) and scales.shape == (3, B, 3)
    assert np.abs(poses_ref[-1] - poses_ref[0]).max() > 0.1      # the refine moved the poses
    _held("rotations", poses[..., :3], poses_ref[..., :3], scale=1.0)
    _held("translations", poses[..., 3], poses_ref[..., 3])
    _held("scales", scales.numpy(), scales_ref)
