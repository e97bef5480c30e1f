"""The loader's device half (`catre_tpu_torch/data/loader.py`, `data/aug.py`'s
depth augmentation, `config/build.py::loader_config_from`) vs the JAX
package's: its group, cached, candidates and presampled builders
(`catre_tpu/data/loader.py` :540-642) fed the same numpy frames, with the
priority and augmentation fields drawn by `jax.random` along the key splits
the JAX builders make. Indices and n_inside equal, points bit-equal.

The port takes the u16 millimetres; the JAX builders take the same depth in
f32 metres, f32(mm) / 1000 exactly rounded. Inside a jit, XLA turns JAX's
`/ 1000.0` into a multiplication by f32(0.001) and reassociates it into the
backprojection, and folds the augmentation's fill and noise scales into the
normal draw's own constant (ROADMAP queue 3), so its clouds lie a few ulp
from the function as written; `test_u16_depth_is_exactly_rounded` pins the
first. The JAX image function run op by op (`_make_one_image_fn` under an
eager vmap) takes the u16 frames and the augmentation as the port does."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.config.build import loader_config_from as j_loader_config_from
from catre_tpu.data import aug as jaug
from catre_tpu.data import loader as jl
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, loader_config_from
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.data import aug as taug
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.entry import example_frames
from catre_tpu_torch.ops import sampling as ts

J = jnp.asarray


def T(a):
    return torch.from_numpy(np.array(a))


def _equal(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        else:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _aug_draws(k_aug, shape, level):
    """The draws of JAX `aug_depth(k_aug, ...)` on a depth of `shape`."""
    k_fill, k_coin_drop, k_drop, k_coin_noise, k_noise = jax.random.split(k_aug, 5)
    k1, k2 = jax.random.split(k_noise)
    return {"fill_draw": jax.random.normal(k_fill, shape),
            "drop_coin_draw": jax.random.uniform(k_coin_drop),
            "keep_draw": jax.random.uniform(k_drop, shape),
            "noise_coin_draw": jax.random.uniform(k_coin_noise),
            "noise_level_draw": jax.random.uniform(k1, (), minval=0.0, maxval=level),
            "noise_draw": jax.random.normal(k2, shape)}


def _group_fields(keys, m, n, train_aug, hw, level):
    """Per image key: the (M, n) priority rows and, under augmentation, the
    aug draws, as the JAX image function splits its key."""
    pri, draws = [], []
    for key in keys:
        if train_aug:
            key, k_aug = jax.random.split(key)
            draws.append(_aug_draws(k_aug, hw, level))
        pri.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
            jax.random.split(key, m))))
    aug = {k: T(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]} if draws else None
    return T(np.stack(pri)), aug


def _cfgs(num_pcl, window, m, train_aug=False, fps=False):
    fields = dict(num_pcl=num_pcl, depth_sample_ball_ratio=0.6, fps_sample=fps,
                  sample_window=window, aug_depth=train_aug, drop_depth_prob=0.5,
                  drop_depth_ratio=0.2, add_noise_depth_prob=0.9, add_noise_depth_level=0.01,
                  max_objs_per_image=m)
    return jl.LoaderConfig(**fields), tl.LoaderConfig(**fields)


def _metres(depth_u16):
    """The exactly rounded f32 metres of u16 millimetres."""
    return depth_u16.astype(np.float32) / np.float32(1000.0)


def _n(cfg, h, w):
    ws = cfg.sample_window
    if ws > 0 and not cfg.fps_sample and (ws < h or ws < w):
        return min(ws, h) * min(ws, w)
    return h * w


def _frames(g=4, h=120, w=160, m=4, seed=0):
    return example_frames(g, h, w, m=m, seed=seed, objs=(1, m), size_px=(16, 70))


GROUP_CASES = {
    # name: (window, train_aug, fps)
    "full_frame": (0, False, False),
    "window": (64, False, False),
    "full_frame_aug": (0, True, False),
    "window_aug": (64, True, False),
    "fps": (0, False, True),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_sampler_matches_jax(case):
    window, train_aug, fps = GROUP_CASES[case]
    m, h, w = 4, 120, 160
    npts = 16 if fps else 64
    jcfg, tcfg = _cfgs(npts, window, m, train_aug, fps)
    f = _frames()
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    args = (f["depth"], f["K"], f["packed"], f["poses"], f["scales"], f["mask_bbox"])
    pri, aug = _group_fields(keys, m, _n(tcfg, h, w), train_aug, (h, w),
                             tcfg.add_noise_depth_level)
    port = tl.make_group_sampler(tcfg, train_aug, device="cpu")(*args, priorities=pri,
                                                                aug_draws=aug)
    # the JAX image function as written, op by op, on the u16 frames
    ref = jax.vmap(jl._make_one_image_fn(jcfg, train_aug))(keys, *map(J, args))
    _equal(ref, port)
    if not train_aug:
        # the jitted group sampler (on exact metres; under augmentation XLA
        # also folds the fill and noise scales into the normal draw's own)
        _equal(jl._make_group_sampler(jcfg, False)(keys, J(_metres(f["depth"])),
                                                   *map(J, args[1:])), port)
    if window and not train_aug:
        # the materialized form gives the fused form's result
        dev = [tl.to_device(a, "cpu") for a in args[:5]]
        _equal(ref, tl.sample_group_from_cloud(tcfg, False, *dev, priorities=pri))
    assert (port[2] == 0).any()           # padded slots: index 0 repeated
    pad = port[2] == 0
    assert port[1][pad].eq(port[1][pad][:, :1]).all()


@pytest.mark.parametrize("window", [0, 64])
def test_cached_sampler_and_the_frozen_eval_split_match_jax(window):
    m, h, w, npts = 4, 120, 160, 64
    jcfg, tcfg = _cfgs(npts, window, m)
    f = _frames(g=6, seed=1)
    table = (f["depth"], f["packed"], f["K"], f["poses"], f["scales"], f["mask_bbox"])
    jtable = [J(_metres(f["depth"]))] + [J(a) for a in table[1:]]
    idx = np.array([4, 1, 3], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    ref = jl._make_cached_group_sampler(jcfg, False)(*jtable, keys, J(idx))
    pri, _ = _group_fields(keys, m, _n(tcfg, h, w), False, (h, w), 0.0)
    port = tl.make_cached_group_sampler(tcfg, False, device="cpu")(*table, idx, priorities=pri)
    _equal(ref, port)
    if not window:
        return
    all_rows = np.arange(6, dtype=np.int32)
    jcand = jl._make_candidates_builder(jcfg)(*jtable, J(all_rows))
    tcand = tl.make_candidates_builder(tcfg, device="cpu")(*table, all_rows)
    _equal(jcand, tcand)
    jpre = jl._make_presampled_group_sampler(jcfg, w, window)(*jcand, keys, J(idx))
    tpre = tl.make_presampled_group_sampler(tcfg, w, window, device="cpu")(
        *tcand, idx, priorities=pri)
    _equal(jpre, tpre)
    _equal(ref, tpre)


def test_full_size_frames_with_ties():
    """2 images of 480 x 640, window 128, 1024 points: the inside
    candidates share priorities, so the tie rule decides."""
    m, h, w, npts, window = 8, 480, 640, 1024, 128
    jcfg, tcfg = _cfgs(npts, window, m)
    f = example_frames(2, h, w, m=m, seed=2, objs=(4, 8), size_px=(40, 120))
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    args = (f["depth"], f["K"], f["packed"], f["poses"], f["scales"], f["mask_bbox"])
    ref = jl._make_group_sampler(jcfg, False)(keys, J(_metres(f["depth"])), *map(J, args[1:]))
    pri, _ = _group_fields(keys, m, window * window, False, (h, w), 0.0)
    port = tl.make_group_sampler(tcfg, False, device="cpu")(*args, priorities=pri)
    _equal(ref, port)
    _, inside, n_inside, _ = ts.batch_ball_crop_candidates(
        *[tl.to_device(a, "cpu") for a in (f["depth"], f["K"], f["packed"], f["mask_bbox"],
                                           f["poses"], f["scales"])], 0.6, window)
    ties = sum(len(p) - len(set(p.tolist()))
               for p in pri[inside].split(n_inside.flatten().tolist()) if len(p))
    assert ties > 0 and (n_inside > npts).any()


def test_u16_depth_is_exactly_rounded():
    """The port's f32(mm) / 1000 is the exactly rounded quotient, as JAX's
    eager division and the reference's host `load_depth`; JAX's jitted
    loader multiplies by f32(0.001), off on 38850 of the 65536 values."""
    mm = np.arange(65536, dtype=np.uint16)
    port = ts.depth_metres(T(mm)).numpy()
    np.testing.assert_array_equal(port, _metres(mm))
    np.testing.assert_array_equal(port, np.asarray(J(mm).astype(jnp.float32) / 1000.0))
    jitted = np.asarray(jax.jit(lambda d: d.astype(jnp.float32) / 1000.0)(J(mm)))
    np.testing.assert_array_equal(jitted, mm.astype(np.float32) * np.float32(0.001))
    assert (jitted != port).sum() == 38850


@pytest.mark.parametrize("drop,noise", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)])
def test_aug_depth_matches_jax(drop, noise):
    rng = np.random.default_rng(4)
    depth = (rng.integers(600, 1600, (40, 56)) / 1000.0).astype(np.float32)
    depth[rng.random((40, 56)) < 0.1] = 0.0
    key = jax.random.PRNGKey(6)
    ref = jaug.aug_depth(key, J(depth), drop_depth_prob=drop, drop_depth_ratio=0.2,
                         add_noise_depth_prob=noise, add_noise_depth_level=0.01)
    draws = {k: T(np.asarray(v)) for k, v in _aug_draws(key, depth.shape, 0.01).items()}
    port = taug.aug_depth(T(depth), drop_depth_prob=drop, drop_depth_ratio=0.2,
                          add_noise_depth_prob=noise, add_noise_depth_level=0.01, **draws)
    _equal([ref], [port])
    gen = torch.Generator().manual_seed(0)
    drawn = taug.aug_depth(T(np.stack([depth, depth])), gen, drop_depth_prob=drop,
                           add_noise_depth_prob=noise, add_noise_depth_level=0.01)
    assert drawn.shape == (2, 40, 56) and torch.isfinite(drawn).all()
    assert not drop or bool((drawn == 0).any())


def test_host_helpers_match_jax():
    rng = np.random.default_rng(7)
    for m in (1, 8, 9, 16, 17, 32, 33):
        assert tl.mask_pack_dtype(m) == jl._mask_pack_dtype(m)
        masks = rng.random((m, 6, 7)) < 0.3
        a, b = tl.pack_masks(masks), jl._pack_masks(masks)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    depth = rng.integers(0, 5000, (8, 9)).astype(np.float32) / 1000.0
    for d in (depth, depth * 100.0, depth - 0.5):
        a, b = tl.quantize_depth(d), jl._quantize_depth(d)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    recs = example_frames(3, 120, 160, m=4, seed=3, objs=(1, 4), size_px=(16, 70))["records"]
    for phase in ("test", "train"):
        assert tl.auto_sample_window(recs, phase) == jl.auto_sample_window(recs, phase)
    assert tl.auto_sample_window([{"annotations": [{"bbox": None}]}], "train") == 0
    for window, fps, aug, phase in [(0, False, False, "test"), (64, False, False, "test"),
                                    (64, True, False, "test"), (64, False, True, "train"),
                                    (64, False, True, "test")]:
        jcfg, tcfg = _cfgs(64, window, 4, aug, fps)
        assert tl.wants_mask_bbox(tcfg, phase) == jl._wants_mask_bbox(jcfg, phase)
    masks = np.zeros((3, 10, 12), bool)
    masks[0, 2:5, 3:9] = True
    masks[2, 9, 0] = True
    np.testing.assert_array_equal(tl.mask_bbox_rows(masks),
                                  [[2, 4, 3, 8], [10, -1, 12, -1], [9, 9, 0, 0]])


@pytest.mark.parametrize("phase", ["test", "train"])
def test_loader_config_from_the_shipped_config(phase):
    cfg = load_config(str(FLAGSHIP_CONFIG))
    port = loader_config_from(cfg, phase)
    from catre_tpu.config.loader import load_config as j_load_config

    ref = j_loader_config_from(j_load_config(str(FLAGSHIP_CONFIG)), phase)
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), field.name
    assert port.sample_window == -1 and port.aug_depth == (phase == "train")
    with pytest.raises(ValueError, match="auto_sample_window"):
        tl.make_group_sampler(port, False, device="cpu")


@pytest.mark.parametrize("key,value", [("PCL_WITH_COLOR", True), ("OCCLUDE_MASK_TEST", True),
                                       ("WITH_NOCS", True), ("KPS_TYPE", "fps")])
def test_loader_config_refuses_features_the_port_lacks(key, value):
    """The aligned RGB path, the test occlusion and the FPS keypoints are
    carried as the JAX bridge carries them (no key sets the NOCS path, in
    either package); what the port lacks, colour augmentation and background
    replacement at train, raises and names its item."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    cfg.INPUT[key] = value
    from catre_tpu.config.loader import load_config as j_load_config

    jcfg = j_load_config(str(FLAGSHIP_CONFIG))
    jcfg.INPUT[key] = value
    port, ref = loader_config_from(cfg, "test"), j_loader_config_from(jcfg, "test")
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), field.name
    assert port.occlude_mask_test == (key == "OCCLUDE_MASK_TEST")
    assert (port.kps_type == "fps") == (key == "KPS_TYPE")
    assert port.pcl_with_color == (key == "PCL_WITH_COLOR") and not port.with_nocs
    for lacking in ("COLOR_AUG_PROB", "CHANGE_BG_PROB"):
        cfg.INPUT[lacking] = 0.5
        with pytest.raises(NotImplementedError, match="item 12c"):
            loader_config_from(cfg, "train")
        loader_config_from(cfg, "test")            # the test phase reads neither, as JAX's
        cfg.INPUT[lacking] = 0.0
    assert key != "KPS_TYPE" or not port.ship_mean_points      # FPS keypoints read no mean points
