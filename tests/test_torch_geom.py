"""Port geometry and composition vs the JAX package, every branch (1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catre_tpu.geom import rotations as jrot
from catre_tpu.geom import transforms as jtf
from catre_tpu.models.compose import pose_scale_from_delta_init as j_compose
from catre_tpu_torch.geom import rotations as trot
from catre_tpu_torch.geom import transforms as ttf
from catre_tpu_torch.models.compose import pose_scale_from_delta_init as t_compose

TOL = 1e-5


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _rot_input(rot_type, rng, b=16):
    x = rng.normal(size=(b, jrot.get_rot_dim(rot_type))).astype(np.float32)
    if "lie_vec" in rot_type or "log_quat" in rot_type:
        x[:3] *= 1e-4   # rows on the small-angle branches
    return x


@pytest.mark.parametrize("rot_type", sorted(jrot.ROT_DIMS))
def test_rot_rep_to_mat(rot_type):
    x = _rot_input(rot_type, np.random.default_rng(0))
    _close(trot.rot_rep_to_mat(torch.from_numpy(x), rot_type),
           jrot.rot_rep_to_mat(jnp.asarray(x), rot_type))
    assert trot.get_rot_dim(rot_type) == jrot.get_rot_dim(rot_type)


def test_rot_rep_to_mat_rejects_unknown():
    with pytest.raises(ValueError):
        trot.rot_rep_to_mat(torch.zeros(2, 6), "ego_euler")


def test_allo_to_ego_mat():
    rng = np.random.default_rng(1)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    t[:, 2] = np.abs(t[:, 2]) + 0.5
    R = np.array(jrot.rot6d_to_mat(jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))))
    _close(trot.allo_to_ego_mat(torch.from_numpy(t), torch.from_numpy(R)),
           jrot.allo_to_ego_mat(jnp.asarray(t), jnp.asarray(R)))


@pytest.mark.parametrize("with_t,with_scale", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_transform_normed_pts(with_t, with_scale):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32)
    R = rng.normal(size=(4, 3, 3)).astype(np.float32)
    t = rng.normal(size=(4, 3)).astype(np.float32) if with_t else None
    s = rng.uniform(0.1, 0.3, size=(4, 3)).astype(np.float32) if with_scale else None
    to_t = (lambda a: None if a is None else torch.from_numpy(a))
    to_j = (lambda a: None if a is None else jnp.asarray(a))
    _close(ttf.transform_normed_pts(to_t(pts), to_t(R), to_t(t), to_t(s)),
           jtf.transform_normed_pts(to_j(pts), to_j(R), to_j(t), to_j(s)))


def test_transform_pts_and_pose_compose():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(3, 20, 3)).astype(np.float32)
    R = rng.normal(size=(3, 3, 3)).astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    _close(ttf.transform_pts(*map(torch.from_numpy, (pts, R, t))),
           jtf.transform_pts(*map(jnp.asarray, (pts, R, t))))
    _close(ttf.pose_compose_3x4(torch.from_numpy(R), torch.from_numpy(t)),
           jtf.pose_compose_3x4(jnp.asarray(R), jnp.asarray(t)))


@pytest.mark.parametrize("space,z_style,k_aware,scale_type,allo", [
    ("image", "cosypose", True, "iter_add", False),     # the shipped config
    ("image", "deepim", True, "iter_mul", False),
    ("image", "cosypose", False, "mean_add", True),
    ("image", "deepim", False, "mean_mul", True),
    ("3D", "cosypose", True, "iter_add", True),
    ("3D", "deepim", False, "iter_mul", False),
])
def test_pose_scale_from_delta_init(space, z_style, k_aware, scale_type, allo):
    rng = np.random.default_rng(4)
    b = 8
    arrays = dict(
        rot_deltas=np.array(jrot.rot6d_to_mat(jnp.asarray(rng.normal(size=(b, 6)), jnp.float32))),
        trans_deltas=rng.normal(size=(b, 3)) * np.array([5.0, 5.0, 0.1]) + np.array([0, 0, 1.0]),
        scale_deltas=rng.normal(size=(b, 3)) * 0.05,
        rot_inits=np.array(jrot.rot6d_to_mat(jnp.asarray(rng.normal(size=(b, 6)), jnp.float32))),
        trans_inits=np.concatenate([rng.uniform(-0.2, 0.2, (b, 2)),
                                    rng.uniform(0.6, 1.2, (b, 1))], 1),
        scale_inits=rng.uniform(0.1, 0.3, (b, 3)),
        Ks=np.tile(np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]]), (b, 1, 1)),
    )
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    kw = dict(K_aware=k_aware, delta_T_space=space, delta_T_weight=0.7,
              delta_z_style=z_style, is_allo=allo, scale_type=scale_type)
    port = t_compose(**{k: torch.from_numpy(v) for k, v in arrays.items()}, **kw)
    ref = j_compose(**{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    for p, r in zip(port, ref):
        _close(p, r)
