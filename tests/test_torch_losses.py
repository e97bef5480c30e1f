"""Port losses, symmetry, errors and augmentation vs the JAX package on the
CPU, the same numpy inputs through both (values and gradients 1e-5):
  - `pm_loss` in every branch, `sym_flag` mixed, one row masked by `valid`;
  - `catre_loss` with the shipped `LossConfig` and each rot/y-axis/trans/scale
    loss type;
  - the symmetry bank and `closest_rot_batch`, rotation and translation errors;
  - each augmentation function driven by its override arguments.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.data import aug as jaug
from catre_tpu.geom import errors as jerr
from catre_tpu.geom import rotations as jrot
from catre_tpu.geom import symmetry as jsym
from catre_tpu.losses import LossConfig as JaxLossConfig
from catre_tpu.losses import catre_loss as jax_catre_loss
from catre_tpu.losses import pm_loss as jax_pm_loss
from catre_tpu_torch.data import aug as taug
from catre_tpu_torch.geom import errors as terr
from catre_tpu_torch.geom import rotations as trot
from catre_tpu_torch.geom import symmetry as tsym
from catre_tpu_torch.losses import LossConfig, catre_loss, pm_loss

TOL = 1e-5
B = 6
BANK = jsym.axis_symmetry_rotation_bank(max_sym_disc_step=0.1)


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _rots(rng, b=B):
    return np.asarray(jrot.euler_to_mat(jnp.asarray(rng.uniform(-np.pi, np.pi, (b, 3)),
                                                    dtype=jnp.float32)))


def _case(seed):
    """Predictions near the gt, mixed symmetry, row 2 invalid."""
    rng = np.random.default_rng(seed)
    gt_rot = _rots(rng)
    noise = np.asarray(jrot.euler_to_mat(jnp.asarray(rng.normal(size=(B, 3)) * 0.3,
                                                     dtype=jnp.float32)))
    f32 = np.float32
    return dict(
        pred_rot=np.einsum("bij,bjk->bik", noise, gt_rot).astype(f32), gt_rot=gt_rot,
        pred_t=(rng.normal(size=(B, 3)) * 0.1 + [0, 0, 1]).astype(f32),
        gt_t=(rng.normal(size=(B, 3)) * 0.1 + [0, 0, 1]).astype(f32),
        pred_s=rng.uniform(0.1, 0.3, (B, 3)).astype(f32),
        gt_s=rng.uniform(0.1, 0.3, (B, 3)).astype(f32),
        kps=(rng.normal(size=(B, 32, 3)) * 0.3).astype(f32),
        sym=np.arange(B) % 2 == 0, valid=np.arange(B) != 2)


PRED = ("pred_rot", "pred_t", "pred_s")


def _both(case, jax_fn, port_fn):
    """Loss dicts and the gradients of their sum w.r.t. the predictions, in
    both packages."""
    def jtotal(pr, pt, ps):
        d = jax_fn(jnp.asarray(pr), jnp.asarray(pt), jnp.asarray(ps))
        return sum(d.values()), d

    (_, jd), jg = jax.value_and_grad(jtotal, argnums=(0, 1, 2), has_aux=True)(
        *(case[k] for k in PRED))
    preds = [torch.from_numpy(case[k]).float().requires_grad_() for k in PRED]
    td = port_fn(*preds)
    tg = torch.autograd.grad(sum(td.values()), preds, allow_unused=True)
    assert sorted(td) == sorted(jd)
    for k in jd:
        _close(td[k], jd[k])
    for p, t, j in zip(preds, tg, jg):   # an unused prediction: None here, zeros in JAX
        _close(torch.zeros_like(p) if t is None else t, j)


def _t(case, k):
    return torch.from_numpy(np.array(case[k]))


PM_BRANCHES = {
    "r_only": {},
    "rt": dict(r_only=False),
    "disentangle_t": dict(r_only=False, disentangle_t=True),
    "disentangle_t_noP": dict(r_only=False, disentangle_t=True, t_loss_use_points=False),
    "disentangle_z": dict(r_only=False, disentangle_z=True),
    "disentangle_z_noP": dict(r_only=False, disentangle_z=True, t_loss_use_points=False),
    "no_scale_no_sym": dict(with_scale=False, symmetric=False),
    "norm_by_extent": dict(norm_by_extent=True),
}


@pytest.mark.parametrize("loss_type", ["L1", "smooth_l1", "mse", "L2"])
@pytest.mark.parametrize("branch", sorted(PM_BRANCHES))
def test_pm_loss(loss_type, branch):
    case = _case(1)
    kw = dict(loss_type=loss_type, beta=0.05, loss_weight=1.5, **PM_BRANCHES[branch])

    def jfn(pr, pt, ps):
        return jax_pm_loss(pr, jnp.asarray(case["gt_rot"]), jnp.asarray(case["kps"]), pt,
                           jnp.asarray(case["gt_t"]), ps, jnp.asarray(case["gt_s"]),
                           jnp.asarray(case["sym"]), jnp.asarray(BANK),
                           jnp.asarray(case["valid"]), extents=jnp.asarray(case["gt_s"]), **kw)

    def tfn(pr, pt, ps):
        return pm_loss(pr, _t(case, "gt_rot"), _t(case, "kps"), pt, _t(case, "gt_t"), ps,
                       _t(case, "gt_s"), _t(case, "sym"), torch.from_numpy(BANK),
                       _t(case, "valid"), extents=_t(case, "gt_s"), **kw)

    _both(case, jfn, tfn)


LOSS_VARIANTS = {
    "shipped": {},
    "yaxis_smoothL1": dict(rot_yaxis_loss_type="smoothL1"),
    "yaxis_L2": dict(rot_yaxis_loss_type="L2"),
    "yaxis_angular": dict(rot_yaxis_loss_type="angular"),
    "rot_L2_trans_L2_scale_L2": dict(rot_loss_type="L2", trans_loss_type="L2",
                                     scale_loss_type="L2"),
    "trans_lpnp_smooth": dict(trans_loss_disentangle=False, trans_loss_type="smooth_L1",
                              scale_loss_type="MSE"),
    "pm_rt_no_rot": dict(pm_r_only=False, rot_lw=0.0, pm_loss_type="smooth_L1"),
}


@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
def test_catre_loss(variant):
    case = _case(2)
    over = LOSS_VARIANTS[variant]
    jcfg = dataclasses.replace(JaxLossConfig(), **over)
    cfg = dataclasses.replace(LossConfig(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

    def jfn(pr, pt, ps):
        return jax_catre_loss(jcfg, pr, pt, ps, jnp.asarray(case["gt_rot"]),
                              jnp.asarray(case["gt_t"]), jnp.asarray(case["gt_s"]),
                              jnp.asarray(case["kps"]), jnp.asarray(case["sym"]),
                              jnp.asarray(BANK), jnp.asarray(case["valid"]))

    def tfn(pr, pt, ps):
        return catre_loss(cfg, pr, pt, ps, _t(case, "gt_rot"), _t(case, "gt_t"),
                          _t(case, "gt_s"), _t(case, "kps"), _t(case, "sym"),
                          torch.from_numpy(BANK), _t(case, "valid"))

    _both(case, jfn, tfn)


@pytest.mark.parametrize("step", [0.01, 0.1, 0.7])
def test_symmetry_bank(step):
    np.testing.assert_array_equal(tsym.axis_symmetry_rotation_bank(max_sym_disc_step=step),
                                  jsym.axis_symmetry_rotation_bank(max_sym_disc_step=step))


def test_closest_rot_batch():
    case = _case(3)
    bank = jsym.axis_symmetry_rotation_bank()
    ref = jsym.closest_rot_batch(*(jnp.asarray(case[k]) for k in ("pred_rot", "gt_rot", "sym")),
                                 jnp.asarray(bank))
    out = tsym.closest_rot_batch(_t(case, "pred_rot"), _t(case, "gt_rot"), _t(case, "sym"),
                                 torch.from_numpy(bank))
    _close(out, ref)
    # non-symmetric rows keep the gt
    np.testing.assert_array_equal(out.numpy()[~case["sym"]], case["gt_rot"][~case["sym"]])


def test_errors_and_euler():
    case = _case(4)
    _close(terr.rotation_error_deg(_t(case, "pred_rot"), _t(case, "gt_rot")),
           jerr.rotation_error_deg(jnp.asarray(case["pred_rot"]), jnp.asarray(case["gt_rot"])),
           atol=1e-3)   # degrees: arccos near 0 amplifies f32 rounding
    _close(terr.translation_error(_t(case, "pred_t"), _t(case, "gt_t")),
           jerr.translation_error(jnp.asarray(case["pred_t"]), jnp.asarray(case["gt_t"])))
    angles = np.random.default_rng(5).uniform(-np.pi, np.pi, (7, 3)).astype(np.float32)
    _close(trot.euler_to_mat(torch.from_numpy(angles)), jrot.euler_to_mat(jnp.asarray(angles)))


def test_aug_poses_and_scales():
    case = _case(6)
    pose = np.concatenate([case["gt_rot"], case["gt_t"][:, :, None]], axis=2)
    rng = np.random.default_rng(6)
    euler = (rng.normal(size=(B, 3)) * 30).astype(np.float32)   # some beyond max_rot
    dt = (rng.normal(size=(B, 3)) * 0.5).astype(np.float32)     # some z below min_z
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    ref = jaug.aug_poses_normal(key, jnp.asarray(pose), jnp.asarray([10.0]),
                                jnp.asarray([[0.01] * 3]), max_rot=20.0, min_z=0.9,
                                euler_deg_override=euler, trans_noise_override=dt)
    out = taug.aug_poses_normal(gen, torch.from_numpy(pose), [10.0], [[0.01] * 3], max_rot=20.0,
                                min_z=0.9, euler_deg_override=euler, trans_noise_override=dt)
    _close(out, ref)
    noise = (rng.normal(size=(B, 3)) * 0.2).astype(np.float32)
    ref = jaug.aug_scale_normal(key, jnp.asarray(case["gt_s"]), jnp.asarray([[0.01] * 3]),
                                min_s=0.05, max_s=0.35, noise_override=noise)
    out = taug.aug_scale_normal(gen, _t(case, "gt_s"), [[0.01] * 3], min_s=0.05, max_s=0.35,
                                noise_override=noise)
    _close(out, ref)


def test_aug_3d_bbox_and_rt():
    case = _case(7)
    pose = np.concatenate([case["gt_rot"], case["gt_t"][:, :, None]], axis=2)
    pcl = (case["kps"] + case["gt_t"][:, None, :]).astype(np.float32)
    key, gen = jax.random.PRNGKey(1), torch.Generator().manual_seed(1)
    ratios = np.asarray([0.85, 1.1, 1.17], np.float32)
    ref = jaug.aug_3d_bbox(key, jnp.asarray(pcl), jnp.asarray(pose), jnp.asarray(case["gt_s"]),
                           jnp.asarray(case["sym"]), ratios_e=ratios)
    out = taug.aug_3d_bbox(gen, torch.from_numpy(pcl), torch.from_numpy(pose), _t(case, "gt_s"),
                           _t(case, "sym"), ratios_e=ratios)
    for o, r in zip(out, ref):
        _close(o, r)
    rxyz, dt = np.asarray([7.0, -12.0, 3.5], np.float32), np.asarray([0.004, -0.003, 0.02],
                                                                      np.float32)
    ref = jaug.aug_rt(key, jnp.asarray(pcl), jnp.asarray(pose), rxyz_deg=rxyz, dt_override=dt)
    out = taug.aug_rt(gen, torch.from_numpy(pcl), torch.from_numpy(pose), rxyz_deg=rxyz,
                      dt_override=dt)
    for o, r in zip(out, ref):
        _close(o, r)


def test_maybe_apply_takes_one_coin_per_batch():
    gen = torch.Generator().manual_seed(0)
    old = (torch.zeros(3),)
    assert taug.maybe_apply(gen, 1.0, lambda g: (torch.ones(3),), old)[0].sum() == 3
    assert taug.maybe_apply(gen, 0.0, lambda g: (torch.ones(3),), old) is old
