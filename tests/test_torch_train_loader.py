"""The port's train-phase `CATRELoader` (`catre_tpu_torch/data/loader.py`)
against the JAX `CATRELoader(phase="train")` (`catre_tpu/data/loader.py`
:645), and its own positional draws, on a split written by
`entry.write_example_split` (120 x 160 frames, 4 slots, 64 points).

Parity, as `tests/test_torch_catre_loader.py` holds the test phase: both
loaders read the same files, the JAX loader's mean-shape table is patched to
the seeded one the port is handed, and the port takes the priority and
augmentation fields the JAX loader draws from its image keys (the `draws`
and `aug_draws` hooks, along the key splits of JAX `_make_one_image_fn`).
- The record stream (`_train_records`) is exact over three epochs, under
  both samplers and for the ranks of a world of 2.
- Every host field, `last_frame_poses`, `nocs`, `pcl_rgb` and `scene_im_ids`
  are bit-equal.
- The clouds are bit-equal to JAX's image function run op by op (an eager
  `jax.vmap` of `_make_one_image_fn`, as
  `test_torch_loader_device.py::test_group_sampler_matches_jax[*_aug]` holds
  the device half) and, against JAX's jitted loader, within 2 ulp of each
  point's depth: inside the jit XLA multiplies by f32(0.001) for `/ 1000.0`
  and reassociates it into the backprojection (the test phase's bound,
  `tests/test_torch_catre_loader.py`), and under the augmentation it also
  folds the fill's 0.1 into the normal draw's own constant. The fill values are drawn only where the depth is 0, far from
  every ball; the noise is a sum `depth + noise` rounded to the depth's
  spacing, so the bound stays 2 ulp of the depth there too.
"""

import collections
import itertools
import pickle

import numpy as np
import pytest
import torch

import jax

from catre_tpu.data import assets as jassets
from catre_tpu.data import loader as jl
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import meta
from catre_tpu_torch.entry import write_example_split

from test_torch_loader_device import _group_fields

M, NPCL, H, W = 4, 64, 120, 160
LEVEL = 0.01
TABLE = np.random.default_rng(11).normal(size=(6, 1024, 3)).astype(np.float32)
MUG = {"mug_a": (np.array([0.01, -0.02, 0.03], np.float32), 0.8)}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """7 records of 120 x 160 with colour and coordinate images, the third
    without annotations; one instance is the mug `mug_a` (of the patched mug
    table) in the NOCS remap."""
    recs = write_example_split(str(tmp_path_factory.mktemp("split")), 7, h=H, w=W, m=M, seed=7,
                               images=True)
    recs[2] = dict(recs[2], annotations=[])
    recs[1] = dict(recs[1], annotations=[dict(a) for a in recs[1]["annotations"]])
    recs[1]["annotations"][0]["inst_name"] = "mug_a_norm"
    return recs


@pytest.fixture(autouse=True)
def _patched(monkeypatch):
    monkeypatch.setattr(jassets, "mean_shape_array", lambda *a, **k: TABLE)
    monkeypatch.setattr(jassets, "load_mug_meta", lambda *a, **k: MUG)
    monkeypatch.setattr(tassets, "load_mug_meta", lambda *a, **k: MUG)
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()
    yield
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()


def _fields(**kw):
    f = dict(num_pcl=NPCL, depth_sample_ball_ratio=0.6, sample_window=-1, aug_depth=True,
             max_objs_per_image=M, add_noise_depth_level=LEVEL)
    f.update(kw)
    return f


class JaxDraws:
    """The JAX loader's fields for stream positions gs: its image keys
    split as its image function splits them (priorities, augmentation)."""

    def __init__(self, seed, train_aug):
        self.seed, self.train_aug, self.memo = seed, train_aug, {}

    def _fields(self, gs, n, hw):
        key = (tuple(gs), n, hw)
        if key not in self.memo:
            keys = [jax.numpy.asarray(tl.image_key(self.seed, g)) for g in gs]
            self.memo[key] = _group_fields(keys, M, n, self.train_aug, hw, LEVEL)
        return self.memo[key]

    def draws(self, gs, shape, device):
        n = shape[2]
        hw = (H, W)
        return self._fields(gs, n, hw)[0].to(device)

    def aug_draws(self, gs, shape, device):
        n = 64 * 64           # the auto window of this split (asserted below)
        return {k: v.to(device) for k, v in self._fields(gs, n, tuple(shape[1:]))[1].items()}


def _port(split, phase="train", ims=2, seed=0, jax_draws=True, **kw):
    loader_kw = {k: kw.pop(k) for k in list(kw) if k not in tl.LoaderConfig.__dataclass_fields__}
    loader_kw.setdefault("mean_points", TABLE)
    cfg = tl.LoaderConfig(**_fields(**kw))
    if jax_draws:
        jd = JaxDraws(seed, cfg.aug_depth and phase == "train")
        loader_kw.setdefault("draws", jd.draws)
        loader_kw.setdefault("aug_draws", jd.aug_draws)
    return tl.CATRELoader(split, cfg, phase=phase, ims_per_batch=ims, seed=seed, device="cpu",
                          **loader_kw)


def _jax(split, phase="train", ims=2, seed=0, **kw):
    loader_kw = {k: kw.pop(k) for k in list(kw) if k not in jl.LoaderConfig.__dataclass_fields__}
    return jl.CATRELoader(split, jl.LoaderConfig(**_fields(**kw)), phase=phase,
                          ims_per_batch=ims, seed=seed, **loader_kw)


def _records(loader, n):
    return [(g, didx) for g, didx, _ in itertools.islice(loader._train_records(), n)]


def _clouds(batch):
    pcl = batch["pcl"]
    return pcl.numpy() if torch.is_tensor(pcl) else np.asarray(pcl)


def _group_positions(split, ims, n_groups, seed=0):
    """The stream positions of the first groups: the records of the train
    stream, those without annotations passed over."""
    ref = jl.CATRELoader(split, jl.LoaderConfig(**_fields()), phase="train", seed=seed)
    gs = [g for g, didx, rec in itertools.islice(ref._train_records(), 4 * ims * n_groups)
          if rec.get("annotations")]
    return [gs[i * ims:(i + 1) * ims] for i in range(n_groups)]


# ---- the index streams

@pytest.mark.parametrize("sampler", ["TrainingSampler", "RepeatFactorTrainingSampler"])
def test_record_stream_matches_jax(split, sampler):
    """Three epochs of (position, dataset index), the repeat factors, the
    ranks of a world of 2 interleaving into the world of 1, and `skip()`
    across an epoch boundary."""
    kw = dict(sampler_train=sampler, repeat_threshold=0.8)
    port, ref = _port(split, **kw), _jax(split, **kw)
    if sampler == "RepeatFactorTrainingSampler":
        factors = tl.repeat_factors_from_category_frequency(split, 0.8)
        np.testing.assert_array_equal(
            factors, jl.repeat_factors_from_category_frequency(split, 0.8))
        assert factors.max() > 1.0          # rare categories are repeated
    n = 3 * len(split) + 5
    stream = _records(port, n)
    assert stream == _records(ref, n)
    assert [g for g, _ in stream] == list(range(n))
    epochs = collections.Counter(didx for _, didx in stream[:len(ref._epoch_indices(0))])
    if sampler == "TrainingSampler":
        assert sorted(epochs) == list(range(len(split))) and set(epochs.values()) == {1}
    else:                                   # the epochs' lengths vary with the rounding
        assert len({len(port._epoch_indices(e)) for e in range(6)}) > 1
    ranks = [_records(_port(split, rank=r, world_size=2, **kw), n // 2) for r in (0, 1)]
    assert ranks == [_records(_jax(split, rank=r, world_size=2, **kw), n // 2) for r in (0, 1)]
    assert [x for pair in zip(*ranks) for x in pair] == stream[:2 * (n // 2)]
    first = len(port._epoch_indices(0))
    for skip in (first - 2, first + 3):      # into and over the epoch boundary
        skipped = _port(split, **kw)
        skipped.skip(skip)
        assert _records(skipped, 10) == stream[skip:skip + 10]
    with pytest.raises(ValueError, match="SAMPLER_TRAIN"):
        _port(split, sampler_train="GroupSampler")


# ---- the batches against the JAX loader

CASES = {  # name: (cache_decoded, ims_per_batch, device_batches, aug_depth)
    "uncached_aug": ("", 2, False, True),
    "uncached_plain_devb": ("", 3, True, False),
    "ram_aug": ("ram", 2, False, True),
    "device_aug_devb": ("device", 2, True, True),
    "device_plain": ("device", 2, False, False),
}
N_GROUPS = 4          # 8 or 12 images: over the end of the first epoch (6 with annotations)


def _op_by_op(split, gs, aug):
    """JAX's image function run op by op on the decoded frames of positions
    gs, keys from (seed 0, g): the clouds (G, M, P, 3)."""
    jcfg = jl.LoaderConfig(**_fields(aug_depth=aug, sample_window=64))
    tcfg = tl.LoaderConfig(**_fields(aug_depth=aug, sample_window=64))
    ref = jl.CATRELoader(split, jcfg, phase="train")
    datas = [tl.gather_image_record(split[ref._index_at(g)], tcfg, "train", None, TABLE,
                                    meta.mean_scales_array()) for g in gs]
    args = [jax.numpy.asarray(np.stack([d[k] for d in datas])) for k in
            ("depth_ship", "K", "masks_packed", "obj_pose", "obj_scale", "mask_bbox")]
    keys = jax.numpy.stack([jax.numpy.asarray(tl.image_key(0, g)) for g in gs])
    return np.asarray(jax.vmap(jl._make_one_image_fn(jcfg, aug))(keys, *args)[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_loader_matches_jax(case, split):
    cache, ims, devb, aug = CASES[case]
    kw = dict(cache_decoded=cache, device_batches=devb, aug_depth=aug)
    ref = list(itertools.islice(iter(_jax(split, ims=ims, **kw)), N_GROUPS))
    loader = _port(split, ims=ims, num_workers=2 if cache == "" else 0, **kw)
    port = list(itertools.islice(iter(loader), N_GROUPS))
    assert loader.cfg.sample_window == 64 and loader._train_aug == aug
    for gs, a, b in zip(_group_positions(split, ims, N_GROUPS), ref, port):
        assert a["scene_im_ids"] == b["scene_im_ids"] and None not in b["scene_im_ids"]
        assert set(a) == set(b) and "last_frame_poses" not in b and "nocs" not in b
        for k in set(b) - {"pcl", "scene_im_ids", "file_names"}:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        x, y = np.asarray(a["pcl"]), _clouds(b)
        assert x.shape == y.shape == (ims * M, NPCL, 3) and torch.is_tensor(b["pcl"]) == devb
        depth_ulp = np.spacing(np.abs(x[..., 2:3]))
        assert (np.abs(x - y) <= 2 * depth_ulp).all(), (np.abs(x - y) / depth_ulp).max()
        np.testing.assert_array_equal(y, _op_by_op(split, gs, aug).reshape(y.shape))
    # the train phase centres the ball on the gt: the estimate moves no cloud
    moved = [dict(r, annotations=[dict(a, pose_est=a["pose"] * 0) for a in r["annotations"]])
             for r in split]
    again = list(itertools.islice(iter(_port(moved, ims=ims, **kw)), 1))
    np.testing.assert_array_equal(_clouds(again[0]), _clouds(port[0]))


@pytest.mark.parametrize("phase", ["train", "test"])
def test_last_frame_nocs_and_rgb_match_jax(phase, split, tmp_path):
    """The previous-frame poses (a pickle with one image left out and one
    with more instances than slots), the coordinate map's NOCS with the mug
    remap and the colour at the sampled pixels, in both phases."""
    rng = np.random.default_rng(5)
    prev = {r["scene_im_id"]: rng.normal(size=(len(r["annotations"]) + 2 * (i == 3), 3, 5))
            for i, r in enumerate(split) if i != 4}
    path = tmp_path / "last_frame.pkl"
    path.write_bytes(pickle.dumps(prev))
    kw = dict(with_nocs=True, pcl_with_color=True, init_pose_train_path=str(path),
              aug_depth=phase == "train")
    if phase == "train":
        ref = list(itertools.islice(iter(_jax(split, **kw)), N_GROUPS))
        port = list(itertools.islice(iter(_port(split, **kw)), N_GROUPS))
    else:
        ref = [b for b in _jax(split, phase="test", **kw) if not b.get("empty")]
        jd = JaxDraws(0, False)
        port = [b for b in _port(split, phase="test", draws=jd.draws, aug_draws=None, **kw)
                if not b.get("empty")]
    assert len(ref) == len(port) > 1
    seen = set()
    for a, b in zip(ref, port):
        assert a["scene_im_ids"] == b["scene_im_ids"]
        for k in ("last_frame_poses", "nocs", "pcl_rgb", "obj_pose", "valid"):
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype == (bool if k == "valid" else np.float32), k
            assert np.array_equal(x, y), k
        seen.update(s for s in b["scene_im_ids"] if s)
        assert b["nocs"].shape == b["pcl_rgb"].shape == b["pcl"].shape
        assert 0.0 <= b["pcl_rgb"].min() and b["pcl_rgb"].max() <= 1.0
    assert {"example/0001", "example/0003", "example/0004"} <= seen
    lf = next(b for b in port if "example/0004" in b["scene_im_ids"])
    i = lf["scene_im_ids"].index("example/0004")
    default = np.float32([[[0.0, 0.1], [0.0, 0.1], [1.0, 0.1]]])     # t = (0, 0, 1), s = 0.1
    np.testing.assert_array_equal(lf["last_frame_poses"][i * M:(i + 1) * M, :, 3:],
                                  np.tile(default, (M, 1, 1)))


def test_unreadable_images_leave_the_fields_out(split, tmp_path):
    """A missing coordinate or colour image: that batch carries neither
    field, as in the JAX loader; a device cache or device batches with these
    paths are refused as there."""
    recs = [dict(r, coord_file=str(tmp_path / "gone.png"), file_name=str(tmp_path / "no.png"))
            if i == 0 else r for i, r in enumerate(split)]
    kw = dict(with_nocs=True, pcl_with_color=True)
    got = [b for b in _port(recs, phase="test", ims=1, **kw) if not b.get("empty")]
    ref = [b for b in _jax(recs, phase="test", ims=1, **kw) if not b.get("empty")]
    assert [("nocs" in b, "pcl_rgb" in b) for b in got] == \
        [("nocs" in b, "pcl_rgb" in b) for b in ref] == [(False, False)] + [(True, True)] * 5
    with pytest.raises(ValueError, match="device_batches"):
        _port(split, device_batches=True, **kw)
    with pytest.raises(ValueError, match="cache_decoded"):
        _port(split, cache_decoded="ram", with_nocs=True)


def test_do_test_takes_a_colour_config(split, tmp_path, monkeypatch):
    """`engine.runner.do_test` under INPUT.PCL_WITH_COLOR (decoded every
    pass, as the JAX loader requires for the RGB path) turns device batches
    off as JAX's `do_test` does, and predicts what it predicts without it."""
    from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
    from catre_tpu_torch.config.loader import apply_overrides, load_config
    from catre_tpu_torch.data import nocs as tnocs
    from catre_tpu_torch.engine import runner

    monkeypatch.setitem(tnocs._DATASET_REGISTRY, "nocs_test_real", lambda: list(split))
    monkeypatch.setattr(tassets, "mean_shape_array", lambda *a, **k: TABLE)
    preds = []
    for colour in (True, False):
        out = tmp_path / f"colour_{colour}"
        cfg = apply_overrides(load_config(str(FLAGSHIP_CONFIG)), [
            f"OUTPUT_DIR={out}", "SEED=0", f"INPUT.NUM_PCL={NPCL}", "MODEL.CATRE.N_ITER_TEST=1",
            "MODEL.LOAD_POSES_TEST=False", "TEST.IMS_PER_BATCH=2",
            f"DATALOADER.MAX_OBJS_PER_IMAGE={M}", "DATALOADER.NUM_WORKERS=0",
            "DATALOADER.CACHE_DECODED=", f"INPUT.PCL_WITH_COLOR={colour}"])
        res = runner.do_test(cfg, device="cpu")["nocs_test_real"]
        assert sorted(res["results"]) == [0, 1]
        with open(out / "predictions.pkl", "rb") as f:
            preds.append(pickle.load(f))
    for a, b in zip(*preds):
        assert sorted(a) == sorted(b) and len(a) == 6
        for sid in a:
            for k, v in a[sid].items():
                assert v.tobytes() == b[sid][k].tobytes(), (sid, k)


# ---- the loader's own draws: positional, skip(), the law

def test_skip_then_groups_equals_the_unskipped_stream(split):
    """skip(n) and k groups are groups n / ims .. of a loader that did not
    skip, bit for bit, over the device cache and the decode path, with the
    loader's own draws and the augmentation on."""
    recs = [r for r in split if r["annotations"]]
    for kw in (dict(cache_decoded="device", device_batches=True), dict(cache_decoded="")):
        whole = list(itertools.islice(iter(_port(recs, jax_draws=False, **kw)), 5))
        skipped = _port(recs, jax_draws=False, **kw)
        skipped.skip(4)
        got = list(itertools.islice(iter(skipped), 3))
        for a, b in zip(whole[2:], got):
            assert a["scene_im_ids"] == b["scene_im_ids"]
            np.testing.assert_array_equal(_clouds(a), _clouds(b))
            np.testing.assert_array_equal(a["obj_pose"], b["obj_pose"])
        other = list(itertools.islice(iter(_port(recs, seed=1, jax_draws=False, **kw)), 1))
        assert other[0]["scene_im_ids"] != whole[0]["scene_im_ids"]


def test_aug_draws_are_positional_and_follow_the_law():
    """One image's fields depend on (seed, g) only. The coins fall below p
    at rate p, keep > 0.2 holds on 80% of the pixels, the uniforms have
    the moments of U(0, 1) (and the noise level of U(0, level)), the normals
    those of N(0, 1) and its cell shares (chi-square, 9 degrees of freedom,
    p = 0.001 bound 27.88)."""
    keys = np.stack([tl.image_key(3, g) for g in range(12)])
    whole = tl.counter_aug_draws(keys, (12, 30, 40), "cpu", LEVEL)
    part = tl.counter_aug_draws(keys[[4, 9]], (2, 30, 40), "cpu", LEVEL)
    for k in whole:
        np.testing.assert_array_equal(part[k], whole[k][[4, 9]])
        assert whole[k].dtype == torch.float32
    # priorities and the augmentation are separate streams
    pri = tl.counter_draws(keys, (12, 4, 1200), "cpu")
    assert not np.isin(whole["keep_draw"].numpy(), pri.numpy()).mean() > 0.01

    n = 4000
    keys = np.stack([tl.image_key(0, g) for g in range(n)])
    d = tl.counter_aug_draws(keys, (n, 16, 16), "cpu", LEVEL)
    for coin, p in (("drop_coin_draw", 0.5), ("noise_coin_draw", 0.9)):
        rate = float((d[coin] < p).double().mean())
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / n), (coin, rate)
    keep = d["keep_draw"].double()
    assert abs(float((keep > 0.2).double().mean()) - 0.8) < 2e-3
    assert abs(float(keep.mean()) - 0.5) < 2e-3 and abs(float(keep.var()) - 1 / 12) < 1e-3
    lvl = d["noise_level_draw"].double()
    assert 0.0 <= float(lvl.min()) and float(lvl.max()) < LEVEL
    assert abs(float(lvl.mean()) - LEVEL / 2) < 4 * LEVEL / np.sqrt(12 * n)
    for name in ("fill_draw", "noise_draw"):
        z = d[name].double().flatten()
        assert abs(float(z.mean())) < 5e-3 and abs(float(z.var()) - 1.0) < 1e-2, name
        assert abs(float((z ** 3).mean())) < 2e-2 and abs(float((z ** 4).mean()) - 3.0) < 5e-2
        assert float(z.abs().max()) <= np.sqrt(48 * np.log(2)) + 1e-6
        edges = np.array([-np.inf, -1.5, -1.0, -0.5, -0.2, 0.0, 0.2, 0.5, 1.0, 1.5, np.inf])
        from scipy.stats import norm

        expected = np.diff(norm.cdf(edges)) * z.numel()
        counts = np.histogram(z.numpy(), bins=edges)[0]
        assert float(((counts - expected) ** 2 / expected).sum()) < 27.88, name


def test_augmentation_moves_the_clouds_by_its_law(split):
    """With the loader's own draws, augmentation on against off: the same
    records and host fields, other clouds; without augmentation the train
    clouds are the test sampler's with the gt as the estimate."""
    recs = [r for r in split if r["annotations"]]
    on = next(iter(_port(recs, jax_draws=False)))
    off = next(iter(_port(recs, jax_draws=False, aug_depth=False)))
    assert on["scene_im_ids"] == off["scene_im_ids"]
    np.testing.assert_array_equal(on["obj_pose"], off["obj_pose"])
    assert not np.array_equal(_clouds(on), _clouds(off))
    near = np.abs(_clouds(on) - _clouds(off))[off["valid"]]
    assert np.median(near) < 0.05               # the noise is centimetres, not the scene
