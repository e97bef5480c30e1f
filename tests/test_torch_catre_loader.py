"""The port's test-phase `CATRELoader` (`catre_tpu_torch/data/loader.py`)
against the JAX `CATRELoader` (`catre_tpu/data/loader.py` :645), and its own
behaviour, on a split written by `entry.write_example_split`.

Parity: both loaders read the same files; the JAX loader's mean-shape table
is patched to the seeded one the port is handed, and the port draws the
priority fields the JAX loader draws from its image keys (the `draws` hook,
along the key splits of JAX `_make_one_image_fn`). Every host field and
`scene_im_ids` are bit-equal. The clouds are held two ways:
- against the JAX loader, within 2 ulp of each point's depth: inside its
  jit XLA multiplies by f32(0.001) for `/ 1000.0` and reassociates it into
  the backprojection (ROADMAP queue 3), so its points lie a few ulp from the
  function as written. x and y are the depth times a factor below 1 and carry
  its rounding, so the unit is the spacing of the depth, not their own;
- against the port's own device half (`make_group_sampler`, which
  `tests/test_torch_loader_device.py` holds bit-equal to JAX's image
  function run op by op), on the arrays `gather_image_record` decodes:
  tolerance 0.
The behaviour tests mirror `tests/test_frozen_eval.py`,
`test_loader_cache.py` and `test_cache_registry.py`, which cannot run here
(they read the NOCS pickles)."""

import numpy as np
import pytest
import torch

import jax

from catre_tpu.data import assets as jassets
from catre_tpu.data import loader as jl
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import meta
from catre_tpu_torch.entry import shipped_test_loader, write_example_split
from catre_tpu_torch.ops import sampling as ts

from test_torch_loader_device import _group_fields

M, NPCL, H, W = 4, 64, 120, 160
TABLE = np.random.default_rng(11).normal(size=(6, 1024, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """6 records of 120 x 160, the third without annotations."""
    recs = write_example_split(str(tmp_path_factory.mktemp("split")), 6, h=H, w=W, m=M, seed=7)
    recs[2] = dict(recs[2], annotations=[])
    return recs


@pytest.fixture(autouse=True)
def _fresh_registry():
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()
    yield
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()


def jax_draws(seed):
    """The JAX loader's priority fields: its image keys split as its image
    function splits them."""
    def draws(gs, shape, device):
        keys = [jax.numpy.asarray(tl.image_key(seed, g)) for g in gs]
        return _group_fields(keys, shape[1], shape[2], False, None, 0.0)[0].to(device)
    return draws


def _fields(**kw):
    f = dict(num_pcl=NPCL, depth_sample_ball_ratio=0.6, sample_window=-1, aug_depth=False,
             max_objs_per_image=M)
    f.update(kw)
    return f


def _port(split, seed=0, ims=2, **kw):
    loader_kw = {k: kw.pop(k) for k in list(kw) if k not in tl.LoaderConfig.__dataclass_fields__}
    loader_kw.setdefault("mean_points", TABLE)
    return tl.CATRELoader(split, tl.LoaderConfig(**_fields(**kw)), phase="test",
                          ims_per_batch=ims, seed=seed, device="cpu", **loader_kw)


def _clouds(batch):
    return np.asarray(batch["pcl"].numpy() if torch.is_tensor(batch["pcl"]) else batch["pcl"])


def _own_half(loader, split, batch, draws):
    """The batch's clouds from the port's device half, on the decoded arrays."""
    ids = [s for s in batch["scene_im_ids"] if s is not None]
    gs = [next(i for i, r in enumerate(split) if r["scene_im_id"] == s) for s in ids]
    datas = [tl.gather_image_record(split[g], loader.cfg, "test", None, TABLE,
                                    meta.mean_scales_array()) for g in gs]
    pad = loader.ims_per_batch
    idx = [*range(len(datas)), *[0] * (pad - len(datas))]
    stack = [np.stack([d[k] for d in datas])[idx] for k in
             ("depth_ship", "K", "masks_packed", "obj_pose_est", "obj_scale_est", "mask_bbox")]
    n = loader._n_candidates(H, W)
    pri = draws(gs + [gs[0]] * (pad - len(gs)), (pad, M, n), "cpu")
    pcls, _, _ = tl.make_group_sampler(loader.cfg, False, device="cpu")(*stack, priorities=pri)
    return pcls.reshape(pad * M, NPCL, 3).numpy()


CASES = {  # name: (cache_decoded, ims_per_batch, device_batches)
    "uncached_ims1": ("", 1, False),
    "uncached_ims3": ("", 3, False),
    "ram_ims2": ("ram", 2, False),
    "device_ims2": ("device", 2, False),
    "device_frozen_ims3": ("device", 3, True),
    "device_frozen_ims1": ("device", 1, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_test_loader_matches_jax(case, split, monkeypatch):
    cache, ims, devb = CASES[case]
    monkeypatch.setattr(jassets, "mean_shape_array", lambda *a, **k: TABLE)
    ref = list(jl.CATRELoader(split, jl.LoaderConfig(**_fields(cache_decoded=cache)),
                              phase="test", ims_per_batch=ims, device_batches=devb))
    loader = _port(split, ims=ims, cache_decoded=cache, device_batches=devb, draws=jax_draws(0))
    port = list(loader)
    assert len(port) == len(ref) and loader.cfg.sample_window == 64
    assert sum(len(b["scene_im_ids"]) for b in port) >= 5
    for a, b in zip(ref, port):
        assert a["scene_im_ids"] == b["scene_im_ids"]
        if a.get("empty"):
            assert b["empty"] and b["record"] is a["record"]
            continue
        assert set(a) - {"_host_memo"} == set(b)
        for k in set(b) - {"pcl", "scene_im_ids", "file_names"}:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        assert b["file_names"] == a["file_names"]
        x, y = np.asarray(a["pcl"]), _clouds(b)
        assert x.shape == y.shape == (ims * M, NPCL, 3)
        depth_ulp = np.spacing(np.abs(x[..., 2:3]))
        assert (np.abs(x - y) <= 2 * depth_ulp).all(), (np.abs(x - y) / depth_ulp).max()
        np.testing.assert_array_equal(y, _own_half(loader, split, b, jax_draws(0)))
    if devb:
        assert torch.is_tensor(port[0]["pcl"]) and loader._dev is not None
        assert loader._ensure_candidates() is not None       # the presampled path ran
    assert any(None in b["scene_im_ids"] for b in port) == (ims > 1)   # the padded tail


def _by_image(loader):
    """scene_im_id -> (M, P, 3) clouds of every image a pass yields."""
    out = {}
    for b in loader:
        if b.get("empty"):
            continue
        pcl = _clouds(b).reshape(-1, M, NPCL, 3)
        for i, s in enumerate(b["scene_im_ids"]):
            if s is not None:
                out[s] = pcl[i]
    return out


def _same_batches(xs, ys):
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        assert a["scene_im_ids"] == b["scene_im_ids"] and a.get("empty") == b.get("empty")
        if a.get("empty"):
            continue
        np.testing.assert_array_equal(_clouds(a), _clouds(b))
        np.testing.assert_array_equal(a["obj_pose_est"], b["obj_pose_est"])


def test_frozen_and_presampled_equal_the_per_pass_samplers(split):
    kw = dict(ims=3, cache_decoded="device", device_batches=True)
    frozen = _port(split, **kw)
    assert frozen._frozen_eligible() and frozen._ensure_candidates() is not None
    got = list(frozen)
    _same_batches(got, list(_port(split, frozen_eval=False, **kw)))
    _same_batches(got, list(_port(split, presampled_eval=False, **kw)))
    guarded = _port(split, presampled_max_gb=0.0, **kw)
    assert guarded._frozen_eligible() and guarded._ensure_candidates() is None
    _same_batches(got, list(guarded))         # the guard falls back to the cached sampler
    assert frozen.candidates_gb() > 0 and frozen.device_cache_gb() > 0


def test_reset_stream_repeats_and_the_seed_matters(split):
    for kw in (dict(cache_decoded=""), dict(cache_decoded="device", device_batches=True)):
        loader = _port(split, **kw)
        first = list(loader)
        assert list(loader) == []             # the stream is spent
        loader.reset_stream()
        _same_batches(first, list(loader))
        other = [b for b in _port(split, seed=1, **kw) if not b.get("empty")]
        first = [b for b in first if not b.get("empty")]
        assert not np.array_equal(_clouds(first[0]), _clouds(other[0]))


def test_clouds_do_not_depend_on_batching_workers_or_cache(split):
    ref = _by_image(_port(split, ims=1))
    assert len(ref) == 5
    for kw in (dict(ims=3, num_workers=2), dict(ims=2, cache_decoded="ram", num_workers=3),
               dict(ims=2, cache_decoded="device"),
               dict(ims=3, cache_decoded="device", device_batches=True),
               dict(ims=4, cache_decoded="device", device_batches=True, presampled_eval=False)):
        got = _by_image(_port(split, **kw))
        assert got.keys() == ref.keys(), kw
        for s in ref:
            np.testing.assert_array_equal(got[s], ref[s], err_msg=str(kw))


def test_registry_shares_isolates_evicts_and_stays_bounded(split):
    a = _port(split, cache_decoded="device")
    b = _port(split, cache_decoded="device")
    assert b._dev is a._dev and b._ram_cache is a._ram_cache and b._dev_row == a._dev_row
    ck = a._decoded_cache_key()
    tl._DECODED_CACHE_REGISTRY[ck]["dicts"] = list(split)    # a recycled id
    c = _port(split, cache_decoded="device")
    assert c._dev is not a._dev and tl._DECODED_CACHE_REGISTRY[ck]["dicts"] is split
    assert _port(split, cache_decoded="device", share_decoded_cache=False)._dev is not c._dev
    assert _port(split, cache_decoded="device", max_objs_per_image=5)._ram_cache \
        is not c._ram_cache
    assert _port([dict(r) for r in split], cache_decoded="device")._dev is not c._dev
    # fps_sample flips `wants_mask_bbox`: real bounds against the sentinel
    assert _port(split, cache_decoded="ram", fps_sample=True)._ram_cache \
        is not _port(split, cache_decoded="ram")._ram_cache
    for m in range(2, 2 + tl._DECODED_CACHE_MAX + 2):
        _port(split, cache_decoded="ram", max_objs_per_image=m)
    assert len(tl._DECODED_CACHE_REGISTRY) == tl._DECODED_CACHE_MAX
    tl.clear_decoded_caches()
    assert not tl._DECODED_CACHE_REGISTRY
    _same_batches(list(a), list(_port(split, cache_decoded="device", share_decoded_cache=False)))


def test_ship_mean_points_gates_the_mean_points(split):
    with_mp = list(_port(split, cache_decoded="ram"))
    without = list(_port(split, cache_decoded="ram", ship_mean_points=False))
    assert all("obj_mean_points" in b for b in with_mp if not b.get("empty"))
    assert all("obj_mean_points" not in b for b in without)
    b = next(b for b in with_mp if not b.get("empty"))
    np.testing.assert_array_equal(b["obj_mean_points"], TABLE[b["obj_cls"]])
    _same_batches([b for b in with_mp if not b.get("empty")],
                  [b for b in without if not b.get("empty")])


def test_counter_draws_are_positional_and_uniform():
    """One image's field depends on (seed, g) only; the fields select every
    inside candidate equally often (chi-square, 99 degrees of freedom, p =
    0.001 bound 148.2) and without repeats."""
    keys = np.stack([tl.image_key(3, g) for g in range(10)])
    whole = tl.counter_draws(keys, (10, 4, 50), "cpu")
    np.testing.assert_array_equal(tl.counter_draws(keys[[5, 7]], (2, 4, 50), "cpu"),
                                  whole[[5, 7]])
    assert whole.dtype == torch.float32 and 0.0 <= float(whole.min()) and float(whole.max()) < 1.0
    n, n_in, npts, trials = 300, 100, 20, 2000
    keys = np.stack([tl.image_key(0, g) for g in range(trials)])
    pri = tl.counter_draws(keys, (trials, 1, n), "cpu")[:, 0]
    k = 2.0 ** 24                       # 24-bit values: the birthday count of distinct ones
    distinct = k * (1.0 - (1.0 - 1.0 / k) ** pri.numel())
    assert abs(len(torch.unique(pri)) - distinct) < 1e-3 * distinct
    inside = torch.zeros(trials, n, dtype=torch.bool)
    pos = torch.randperm(n, generator=torch.Generator().manual_seed(1))[:n_in]
    inside[:, pos] = True
    idx = ts.select_inside(inside, inside.sum(-1).int(), npts, priorities=pri)
    assert inside.gather(1, idx).all() and all(len(set(r.tolist())) == npts for r in idx)
    counts = torch.bincount(idx.flatten(), minlength=n)[pos].double()
    expected = trials * npts / n_in
    assert float(((counts - expected) ** 2 / expected).sum()) < 148.2
    assert abs(float(pri.double().mean()) - 0.5) < 0.01


def test_loader_refuses_what_it_does_not_do(split, tmp_path, monkeypatch):
    cfg = tl.LoaderConfig(**_fields())
    with pytest.raises(ValueError, match="unknown SAMPLER_TRAIN"):
        tl.CATRELoader(split, tl.LoaderConfig(**_fields(sampler_train="Bogus")), phase="train",
                       device="cpu", mean_points=TABLE)
    with pytest.raises(ValueError, match="unknown phase"):
        tl.CATRELoader(split, cfg, phase="val", device="cpu", mean_points=TABLE)
    with pytest.raises(NotImplementedError, match="item 15"):
        tl.CATRELoader(split, cfg, device="cpu", mean_points=TABLE, defer_selection=True)
    with pytest.raises(ValueError, match="OCCLUDE_MASK_TEST"):
        _port(split, cache_decoded="ram", occlude_mask_test=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            tl.CATRELoader(split, cfg, device="cuda", mean_points=TABLE)
    monkeypatch.setattr(tassets, "mean_shape_array",
                        lambda path=str(tmp_path / "mean.pkl"): tassets.load_mean_shapes(path))
    with pytest.raises(FileNotFoundError, match="mean.pkl"):
        tl.CATRELoader(split, cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        list(_port([dict(split[0], depth_file=str(tmp_path / "gone.png"))]))


def test_shipped_test_loader_reads_the_shipped_config(split):
    loader = shipped_test_loader(split, device="cpu", mean_points=TABLE, num_pcl=NPCL,
                                 ims_per_batch=2, num_workers=2)
    assert loader.cache_mode == "device" and loader.device_batches and loader.num_workers == 2
    assert loader.cfg.sample_window == 64 and loader._frozen_eligible()
    batches = list(loader)
    assert [len(b["scene_im_ids"]) for b in batches] == [2, 2, 2]
    assert batches[0]["pcl"].shape == (2 * 8, NPCL, 3) and torch.isfinite(batches[0]["pcl"]).all()
