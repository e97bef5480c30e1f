"""The init modes of the port's train step (`catre_tpu_torch/engine/train.py`:
`_sample_init_pose`, `_sample_init_scale`, `prepare_train_batch`) against
`catre_tpu/engine/train.py` on the CPU:
  - the cases of `tests/test_init_modes.py`, run on the port;
  - the arithmetic with JAX's own draws handed in (the keys split as JAX
    splits them): random, canonical and last_frame poses and scales, and the
    mode JAX picks from a list, within 1e-6;
  - the law: ranges, orthonormal rotations, `random` uniform on SO(3) (the
    mean of 20000 rotations within 5 sigma of 0 in every entry; the rotation
    angle's KS distance to the uniform law's CDF (t - sin t) / pi below
    0.0138, its 0.1% critical value at n = 20000), one mode a step drawn from
    the generator;
  - last_frame with and without `last_frame_poses`;
  - `noise_config_from` against JAX's, field by field.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.config.build import noise_config_from as jax_noise_config_from
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.engine import train as jax_train
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, noise_config_from
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.data.aug import aug_3d_bbox, aug_rt
from catre_tpu_torch.engine.train import (InputNoiseConfig, _sample_init_pose,
                                          _sample_init_scale, prepare_train_batch)
from catre_tpu_torch.geom.transforms import transform_normed_pts

RNG = np.random.default_rng(9)
NO_AUG = dict(bbox3d_aug_prob=0.0, rt_aug_prob=0.0)


def _batch_np(b=6, last_frame=False):
    R = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    t = np.tile(np.array([0, 0, 1.0], np.float32), (b, 1))
    out = {
        "pcl": RNG.normal(size=(b, 32, 3)).astype(np.float32),
        "obj_pose": np.concatenate([R, t[:, :, None]], axis=2),
        "obj_scale": np.full((b, 3), 0.2, np.float32),
        "sym_flag": np.zeros(b, dtype=bool),
    }
    if last_frame:
        out["last_frame_poses"] = RNG.normal(size=(b, 3, 5)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _prepare(seed, cfg, b=6):
    return prepare_train_batch(torch.Generator().manual_seed(seed), _torch(_batch_np(b)), cfg)


def _orthonormal(pe):
    R = pe[:, :, :3].double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(1, 2), eye, atol=1e-5, rtol=0)


def test_gt_noise_mode():
    out = _prepare(0, InputNoiseConfig(**NO_AUG))
    pe, gt = out["obj_pose_est"], out["obj_pose"]
    assert not torch.allclose(pe, gt)
    assert (pe[:, :, 3] - gt[:, :, 3]).abs().max() < 0.15
    _orthonormal(pe)
    se = out["obj_scale_est"]
    assert (se >= 0.04).all() and (se <= 0.45).all()


def test_random_mode():
    out = _prepare(1, InputNoiseConfig(**NO_AUG, init_pose_types=("random",),
                                       init_scale_types=("random",)))
    t = out["obj_pose_est"][:, :, 3]
    assert (t[:, 2] >= 0.5).all() and (t[:, 2] <= 1.3).all()
    assert (t[:, :2].abs() <= 0.35 + 1e-6).all()
    _orthonormal(out["obj_pose_est"])
    se = out["obj_scale_est"]
    assert (se >= 0.04).all()
    assert (se[:, 0] <= 0.5).all() and (se[:, 1] <= 0.3).all() and (se[:, 2] <= 0.4).all()


def test_canonical_mode():
    out = _prepare(2, InputNoiseConfig(**NO_AUG, init_pose_types=("canonical",),
                                       init_scale_types=("canonical",)))
    pe = out["obj_pose_est"]
    torch.testing.assert_close(pe[0], pe[1], rtol=0, atol=0)
    torch.testing.assert_close(pe[:, :, 3], torch.tensor([[0, 0, 1.0]]).expand(6, 3), atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(out["obj_scale_est"], torch.full((6, 3), 0.2), atol=1e-6, rtol=0)
    _orthonormal(pe)


def test_mixed_modes_dispatch():
    cfg = InputNoiseConfig(**NO_AUG, init_pose_types=("gt_noise", "random", "canonical"))
    n_canon = 0
    for i in range(12):
        t = _prepare(i, cfg)["obj_pose_est"][:, :, 3]
        n_canon += bool(torch.allclose(t, torch.tensor([0, 0, 1.0]).expand(6, 3), atol=1e-6))
    assert 0 < n_canon < 12


def test_aug_3d_bbox_sym_consistency():
    b = 4
    pcl = torch.from_numpy(RNG.normal(size=(b, 64, 3)).astype(np.float32) * 0.1)
    pose = torch.from_numpy(np.tile(np.eye(3, 4, dtype=np.float32), (b, 1, 1)))
    scale = torch.full((b, 3), 0.2)
    sym = torch.tensor([True, True, False, False])
    _, sa = aug_3d_bbox(torch.Generator().manual_seed(3), pcl, pose, scale, sym)
    assert sa[0, 0] == sa[0, 2]
    assert (sa / 0.2 >= 0.8 - 1e-6).all() and (sa / 0.2 <= 1.2 + 1e-6).all()


def test_aug_rt_consistency():
    b = 3
    canonical = torch.from_numpy(RNG.normal(size=(b, 50, 3)).astype(np.float32) * 0.3)
    R = torch.eye(3).expand(b, 3, 3)
    t = torch.tensor([0.1, -0.1, 1.0]).expand(b, 3)
    pose = torch.cat([R, t[:, :, None]], dim=2)
    pcl_aug, pa = aug_rt(torch.Generator().manual_seed(4), transform_normed_pts(canonical, R, t),
                         pose)
    torch.testing.assert_close(pcl_aug, transform_normed_pts(canonical, pa[:, :, :3], pa[:, :, 3]),
                               atol=1e-5, rtol=0)


def _jax_draws(key, types_pose, types_scale, n):
    """The draws JAX's `_sample_init_pose` / `_sample_init_scale` take from
    their keys (`catre_tpu/engine/train.py:80, 120`), as the port's overrides."""
    k_sel, k_a, k_b = jax.random.split(key, 3)
    draws = {"quat": np.array(jax.random.normal(k_a, (n, 4))),
             "trans_uniform": np.array(jax.random.uniform(k_b, (n, 3)))}
    if len(types_pose) > 1:
        draws["pose_mode"] = int(jax.random.randint(k_sel, (), 0, len(types_pose)))
    s_sel, s_a = jax.random.split(key)
    draws["scale_uniform"] = np.array(jax.random.uniform(s_a, (n, 3)))
    if len(types_scale) > 1:
        draws["scale_mode"] = int(jax.random.randint(s_sel, (), 0, len(types_scale)))
    return draws


@pytest.mark.parametrize("pose_types,scale_types", [
    (("random",), ("random",)),
    (("canonical",), ("canonical",)),
    (("last_frame",), ("last_frame",)),
    (("random", "canonical", "last_frame"), ("last_frame", "random", "canonical")),
])
def test_init_arithmetic_matches_jax_with_its_draws(pose_types, scale_types):
    cfg = dict(random_trans_min=(-0.2, -0.3, 0.6), random_scale_max=(0.6, 0.25, 0.45),
               canonical_rot=((0, 1, 0, 0.25), (1, 0, 0, -0.4)), canonical_size=(0.1, 0.3, 0.2))
    jcfg = jax_train.InputNoiseConfig(init_pose_types=pose_types, init_scale_types=scale_types,
                                      **NO_AUG, **cfg)
    pcfg = InputNoiseConfig(init_pose_types=pose_types, init_scale_types=scale_types, **NO_AUG,
                            **cfg)
    batch = _batch_np(8, last_frame=True)
    modes = set()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, pose_types, scale_types, 8)
        modes.add((draws.get("pose_mode"), draws.get("scale_mode")))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want_pose = jax_train._sample_init_pose(key, jb, jcfg)
        want_scale = jax_train._sample_init_scale(key, jb, jcfg)
        got_pose = _sample_init_pose(torch.Generator(), _torch(batch), pcfg, draws)
        got_scale = _sample_init_scale(torch.Generator(), _torch(batch), pcfg, draws)
        np.testing.assert_allclose(got_pose.numpy(), np.asarray(want_pose), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got_scale.numpy(), np.asarray(want_scale), atol=1e-6, rtol=0)
    if len(pose_types) > 1:
        assert len({m[0] for m in modes}) == 3 and len({m[1] for m in modes}) == 3


def test_random_rotations_are_uniform_on_so3():
    n = 20000
    cfg = InputNoiseConfig(init_pose_types=("random",))
    R = _sample_init_pose(torch.Generator().manual_seed(11), _torch(_batch_np(n)),
                          cfg)[:, :, :3].double()
    _orthonormal(R)
    assert torch.allclose(torch.linalg.det(R), torch.ones(n, dtype=torch.float64), atol=1e-5)
    # entries of a uniform rotation: mean 0, variance 1/3
    assert (R.mean(0).abs() < 5 * math.sqrt(1 / 3 / n)).all()
    angle = torch.arccos(((R.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2).clamp(-1, 1))
    angle, _ = torch.sort(angle)
    cdf = (angle - torch.sin(angle)) / math.pi
    ranks = torch.arange(1, n + 1, dtype=torch.float64) / n
    ks = max((ranks - cdf).abs().max().item(), (cdf - (ranks - 1 / n)).abs().max().item())
    assert ks < 1.95 / math.sqrt(n), ks


def test_one_mode_a_step_from_the_generator():
    cfg = InputNoiseConfig(**NO_AUG, init_pose_types=("random", "canonical"),
                           init_scale_types=("canonical", "random"))
    seen = set()
    for seed in range(16):
        a, b = _prepare(seed, cfg), _prepare(seed, cfg)
        torch.testing.assert_close(a["obj_pose_est"], b["obj_pose_est"], rtol=0, atol=0)
        canonical = bool(torch.allclose(a["obj_pose_est"][:, :, 3],
                                        torch.tensor([0, 0, 1.0]).expand(6, 3)))
        # one mode for the whole batch
        rows_equal = bool(torch.equal(a["obj_pose_est"][0], a["obj_pose_est"][1]))
        assert canonical == rows_equal
        seen.add(canonical)
    assert seen == {True, False}


def test_last_frame_mode_reads_its_field():
    cfg = InputNoiseConfig(**NO_AUG, init_pose_types=("last_frame",),
                           init_scale_types=("last_frame",))
    batch = _torch(_batch_np(4, last_frame=True))
    out = prepare_train_batch(torch.Generator().manual_seed(0), batch, cfg)
    torch.testing.assert_close(out["obj_pose_est"], batch["last_frame_poses"][:, :3, :4],
                               rtol=0, atol=0)
    torch.testing.assert_close(out["obj_scale_est"], batch["last_frame_poses"][:, :3, 4],
                               rtol=0, atol=0)
    del batch["last_frame_poses"]
    with pytest.raises(ValueError, match="last_frame_poses"):
        prepare_train_batch(torch.Generator(), batch, cfg)
    with pytest.raises(ValueError, match="one of"):
        prepare_train_batch(torch.Generator(), batch,
                            dataclasses.replace(cfg, init_pose_types=("gt_nose",)))


@pytest.mark.parametrize("overrides", [{}, {
    "INIT_POSE_TYPE_TRAIN": ["gt_noise", "random", "canonical"],
    "INIT_SCALE_TYPE_TRAIN": ["random"], "RANDOM_TRANS_MIN": [-0.1, -0.2, 0.4],
    "RANDOM_SCALE_MAX": [0.3, 0.3, 0.3], "CANONICAL_ROT": [(0, 1, 0, 0.5)],
    "CANONICAL_TRANS": [0.1, 0.0, 0.9], "CANONICAL_SIZE": [0.1, 0.1, 0.1]}])
def test_noise_config_from_matches_jax(overrides):
    port_cfg, jax_cfg = load_config(str(FLAGSHIP_CONFIG)), jax_load_config(str(FLAGSHIP_CONFIG))
    for cfg in (port_cfg, jax_cfg):
        cfg.INPUT.update(overrides)
    assert dataclasses.asdict(noise_config_from(port_cfg)) == dataclasses.asdict(
        jax_noise_config_from(jax_cfg))
