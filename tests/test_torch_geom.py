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


# ---- geometry the sampler and the evaluator need (ROADMAP item 1)

from catre_tpu.geom import errors as jerr  # noqa: E402
from catre_tpu.geom import symmetry as jsym  # noqa: E402
from catre_tpu_torch.geom import errors as terr  # noqa: E402
from catre_tpu_torch.geom import symmetry as tsym  # noqa: E402


def _rotations(rng, b=16):
    return np.array(jrot.rot6d_to_mat(jnp.asarray(rng.normal(size=(b, 6)).astype(np.float32))))


def test_backproject_and_project_pts():
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.0, 2.0, size=(2, 24, 32)).astype(np.float32)
    depth[:, :4] = 0.0
    K = np.array([[[591.0, 0, 15.5], [0, 590.2, 11.5], [0, 0, 1]],
                  [[500.0, 0, 16.1], [0, 510.0, 12.2], [0, 0, 1]]], np.float32)
    port = ttf.backproject(torch.from_numpy(depth), torch.from_numpy(K))
    for i in range(2):       # one image at a time in JAX; the port also takes a stack
        ref = jtf.backproject(jnp.asarray(depth[i]), jnp.asarray(K[i]))
        np.testing.assert_array_equal(port[i].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            ttf.backproject(torch.from_numpy(depth[i]), torch.from_numpy(K[i])).numpy(),
            np.asarray(ref))
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 0.1
    R = _rotations(rng, 1)[0]
    t = np.array([0.05, -0.02, 1.0], np.float32)
    # pixels of a few hundred: 1e-5 relative, the f32 spacing there
    np.testing.assert_allclose(
        ttf.project_pts(*map(torch.from_numpy, (pts, K[0], R, t))).numpy(),
        np.asarray(jtf.project_pts(*map(jnp.asarray, (pts, K[0], R, t)))), rtol=1e-5, atol=TOL)


def test_pose_3x4_to_4x4():
    pose = np.random.default_rng(6).normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(ttf.pose_3x4_to_4x4_np(pose), jtf.pose_3x4_to_4x4_np(pose))
    np.testing.assert_array_equal(ttf.pose_3x4_to_4x4(torch.from_numpy(pose)).numpy(),
                                  np.asarray(jtf.pose_3x4_to_4x4(jnp.asarray(pose))))


def test_normalize_and_mat_to_rot6d():
    rng = np.random.default_rng(7)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    v[0] = 0.0                                   # the eps branch
    _close(trot.normalize(torch.from_numpy(v)), jrot.normalize(jnp.asarray(v)))
    R = _rotations(rng)
    _close(trot.mat_to_rot6d(torch.from_numpy(R)), jrot.mat_to_rot6d(jnp.asarray(R)))


def _branch_rotations(branch, rng, b=8):
    """Rotations whose largest of (trace, m00, m11, m22) is `branch`: small
    angles for the trace, near-pi turns about x, y or z for the others."""
    axes = rng.normal(size=(b, 3)) * 0.1
    if branch == 0:
        angles = rng.uniform(0.0, 1.0, b)
    else:
        axes[:, branch - 1] = 1.0
        angles = rng.uniform(2.9, np.pi, b)
    return np.array(jrot.axangle_to_mat(jnp.asarray(axes, jnp.float32),
                                        jnp.asarray(angles, jnp.float32)))


@pytest.mark.parametrize("branch", [0, 1, 2, 3])
def test_mat_to_quat_and_lie_vec_every_branch(branch):
    R = _branch_rotations(branch, np.random.default_rng(8 + branch))
    diag = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], 1)
    assert (diag.argmax(1) == branch).all()
    _close(trot.mat_to_quat(torch.from_numpy(R)), jrot.mat_to_quat(jnp.asarray(R)))
    _close(trot.mat_to_lie_vec(torch.from_numpy(R)), jrot.mat_to_lie_vec(jnp.asarray(R)))


def test_rot_from_axangle_chain():
    chain = [(1, 0, 0, 0.5), (0, 1, 0, -0.25), (0.3, 0.2, 1.0, 1.0)]
    _close(trot.rot_from_axangle_chain(chain), jrot.rot_from_axangle_chain(chain))
    np.testing.assert_array_equal(trot.rot_from_axangle_chain([]).numpy(), np.eye(3))


def test_y_rotation_bank_20_exact():
    port, ref = tsym.y_rotation_bank_20(), jsym.y_rotation_bank_20()
    assert port.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(port, ref)


def test_rotation_error_sym_y_and_mean_re_te():
    rng = np.random.default_rng(9)
    R_gt, R_est = _rotations(rng), _rotations(rng)
    R_est[:4] = R_gt[:4] @ np.array(jrot.axangle_to_mat(jnp.asarray([[0.0, 1.0, 0.0]] * 4),
                                                        jnp.asarray([0.1, 0.5, 1.0, 3.0])))
    sym = np.arange(16) % 2 == 0
    t_gt = rng.normal(size=(16, 3)).astype(np.float32)
    t_est = t_gt + rng.normal(size=(16, 3)).astype(np.float32) * 0.01
    _close(terr.rotation_error_deg_sym_y(*map(torch.from_numpy, (R_est, R_gt, sym))),
           jerr.rotation_error_deg_sym_y(*map(jnp.asarray, (R_est, R_gt, sym))))
    port = terr.mean_re_te(*map(torch.from_numpy, (t_est, R_est, t_gt, R_gt)))
    ref = jerr.mean_re_te(*map(jnp.asarray, (t_est, R_est, t_gt, R_gt)))
    _close(port[0], ref[0])
    _close(port[1], ref[1])
