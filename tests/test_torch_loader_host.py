"""The loader's host half (`catre_tpu_torch/data/loader.py`: `load_depth`,
`mask_from_annotation`, `occlude_mask_by_bbox`, `gather_image_record`)
against the JAX package's (`catre_tpu/data/loader.py` :190-428), on files
written by OpenCV and by the port's writer: every field bit-equal.

The JAX loader reads its pickles through `catre_tpu.data.assets`; the tests
patch the functions it calls there (and their port twins) with seeded
tables, since the pickles are not in the repository."""

import numpy as np
import pytest

import cv2

from catre_tpu.data import assets as jassets
from catre_tpu.data import loader as jl
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import meta
from catre_tpu_torch.data.rle import binary_mask_to_rle
from catre_tpu_torch.entry import write_example_split

M, NKPS = 4, 16


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_load_depth_16_bit_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 65536, (30, 40)).astype(np.uint16)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, depth)
    _equal(tl.load_depth(path), jl.load_depth(path), "16-bit depth")
    _equal(tl.load_depth(path), depth.astype(np.float32) / 1000.0, "metres")


def test_load_depth_3_channel_takes_g_high_and_r_low(tmp_path):
    """The encoded 3-channel depth: the JAX code reads channel 1 of OpenCV's
    BGR image (G) as the high byte and channel 2 (R) as the low byte, not B
    as its comment says; the port computes what the code computes."""
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    path = str(tmp_path / "d3.png")
    cv2.imwrite(path, bgr)
    port = tl.load_depth(path)
    _equal(port, jl.load_depth(path), "3-channel depth")
    mm = bgr[..., 1].astype(np.uint16) * 256 + bgr[..., 2].astype(np.uint16)
    _equal(port, mm.astype(np.float32) / 1000.0, "G * 256 + R")
    assert not np.array_equal(port, (bgr[..., 1].astype(np.uint16) * 256 + bgr[..., 0])
                              .astype(np.float32) / 1000.0)


def test_mask_from_annotation_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 20, 30
    seg = rng.random((h, w)) < 0.3
    annos = [{"segmentation": binary_mask_to_rle(seg)},
             {"segmentation": None, "bbox_est": [3.4, 2.6, 12.5, 40.0]},
             {"bbox": [-5, -2, 8.49, 7.5]}, {"bbox_est": [25.0, 15.0, 29.0, 19.0]}, {}]
    for anno in annos:
        _equal(tl.mask_from_annotation(anno, h, w), jl.mask_from_annotation(anno, h, w),
               str(anno))
    _equal(tl.mask_from_annotation(annos[0], h, w), seg, "segmentation")


@pytest.mark.parametrize("bbox", [[2, 3, 14, 18], [0, 0, 19, 19], [5, 5, 6, 6], [8, 2, 10, 30]])
def test_occlude_mask_by_bbox_matches_jax(bbox):
    """The reference indexes rows with x and columns with y; both packages
    keep it, so a bbox off the diagonal occludes the transposed quadrant."""
    rng = np.random.default_rng(3)
    mask = rng.random((20, 20)) < 0.6
    _equal(tl.occlude_mask_by_bbox(tl._derive_rng(0, 0, 1), mask, bbox),
           jl.occlude_mask_by_bbox(jl._derive_rng(0, 0, 1), mask, bbox), str(bbox))
    _equal(tl.occlude_mask_by_bbox(None, np.zeros((20, 20), bool), bbox),
           np.zeros((20, 20), bool), "empty")


def _cfgs(**kw):
    fields = dict(num_pcl=32, depth_sample_ball_ratio=0.6, sample_window=48, aug_depth=False,
                  max_objs_per_image=M, num_kps=NKPS)
    fields.update(kw)
    return jl.LoaderConfig(**fields), tl.LoaderConfig(**fields)


@pytest.fixture
def split(tmp_path):
    return write_example_split(str(tmp_path), 3, h=96, w=128, m=M, seed=4)


@pytest.fixture
def assets_tables(monkeypatch):
    """Seeded per-instance model points and FPS keypoints for both packages."""
    rng = np.random.default_rng(5)
    shapes = {f"inst{i}": rng.normal(size=(1024, 3)).astype(np.float32) for i in range(3)}
    shapes["odd"] = np.zeros((7, 3), np.float32)
    fps = {f"inst{i}": rng.normal(size=(NKPS, 3)).astype(np.float32) for i in range(3)}
    for mod in (jassets, tassets):
        monkeypatch.setattr(mod, "load_mean_shapes", lambda *a, **k: shapes)
        monkeypatch.setattr(mod, "get_fps_points", lambda name, n, *a, **k: fps[name][:n])
    return rng.normal(size=(6, 1024, 3)).astype(np.float32)


CASES = {
    "window": {},
    "full_frame": {"sample_window": 0},
    "no_mean_points": {"ship_mean_points": False},
    "occluded": {"occlude_mask_test": True},
    "fps_kps": {"kps_type": "fps"},
    "cmra": {"_cmra": True},
    "fps_sample": {"fps_sample": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_image_record_matches_jax(case, split, assets_tables):
    kw = dict(CASES[case])
    cmra = kw.pop("_cmra", False)
    jcfg, tcfg = _cfgs(**kw)
    table, scales = assets_tables, meta.mean_scales_array()
    for g, rec in enumerate(split):
        rec = dict(rec, annotations=[dict(a, inst_name=f"inst{i % 3}")
                                     for i, a in enumerate(rec["annotations"])])
        if cmra:
            rec["dataset_name"] = "nocs_cmra_val"
            rec["annotations"][0]["inst_name"] = "unknown"
        ref = jl._gather_image_record(rec, jcfg, "test", jl._derive_rng(0, 0, g), table, scales)
        port = tl.gather_image_record(rec, tcfg, "test", tl._derive_rng(0, 0, g), table, scales)
        assert set(ref) - {"fg_any"} == set(port)
        for k in port:
            if k in ("scene_im_id", "file_name", "n_insts", "cmra_prior"):
                assert ref[k] == port[k], k
            else:
                _equal(ref[k], port[k], f"{case} {k}")
        assert ("obj_mean_points" in port) == (tcfg.ship_mean_points or cmra)
        assert ("obj_fps_points" in port) == (case == "fps_kps")
        if tl.wants_mask_bbox(tcfg, "test"):
            assert (port["mask_bbox"][:, 1] >= 0).any()
    empty = dict(split[0], annotations=[])
    assert tl.gather_image_record(empty, tcfg, "test", None, table, scales) is None


def test_cmra_priors_of_a_wrong_shape_raise(split, assets_tables):
    _, tcfg = _cfgs()
    rec = dict(split[0], dataset_name="cmra_val",
               annotations=[dict(a, inst_name="odd") for a in split[0]["annotations"]])
    with pytest.raises(ValueError, match="odd"):
        tl.gather_image_record(rec, tcfg, "test", None, assets_tables, meta.mean_scales_array())
    _, fcfg = _cfgs(kps_type="fps")
    rec = dict(split[0], annotations=[dict(a) for a in split[0]["annotations"]])
    with pytest.raises(KeyError, match="inst_name"):
        tl.gather_image_record(rec, fcfg, "test", None, assets_tables, meta.mean_scales_array())
