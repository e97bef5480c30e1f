"""The port's test runner (`catre_tpu_torch/engine/runner.py::do_test`) and
dataset registry (`data/nocs.py`) against the JAX package's on the CPU.

The split is `entry.write_example_split`'s (8 frames of 120 x 160, 4 slots),
registered under `nocs_test_real` in both registries. Both sides read the
same reference-layout `.pth` (a `tests/torch_mirror.py` model whose rotation
heads take 64 + 1024 points) as MODEL.WEIGHTS, run the plain f32 refine
(NUM_PCL = 64, N_ITER_TEST = 2) of the shipped `..._120e_tpu.py` with its
fused flags off, and score with their evaluators. The JAX mean-shape table is
patched to a seeded one and so is the port's; the port's loader draws the
JAX loader's priority fields (`draws=jax_draws(0)` through the runner's
`CATRELoader`). Iteration 0 is bit-equal, refined poses and scales within
5e-4 (`tests/test_fused_refine.py`), class ids, scores and boxes bit-equal,
the summary tables equal. Cases: the split's own estimates, an init-pose
JSON (with an image left without detections, FILTER_EMPTY_DETS on and off,
and DET_THR), `canonical`, EVAL_CACHED re-scoring, SAVE_RESULTS_ONLY. The
`gt_noise` init draws from the port's own generator: its law is checked
(std per axis, the rotation clip), its arithmetic against JAX's through the
override arguments of `aug_poses_normal` / `aug_scale_normal`.

The dataset dicts of a fake REAL split (masks written with `png.write_png`,
label pickles, a patched abs-scale table) and `load_init_poses_into_dataset`
are held equal to JAX's."""

import copy
import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.config.loader import apply_overrides as jax_apply_overrides
from catre_tpu.config.loader import load_config as jax_load_config
from catre_tpu.data import assets as jassets
from catre_tpu.data import aug as jaug
from catre_tpu.data import loader as jl
from catre_tpu.data import nocs as jnocs
from catre_tpu.engine import runner as jrunner
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
from catre_tpu_torch.config.loader import apply_overrides, load_config
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import aug as taug
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import nocs as tnocs
from catre_tpu_torch.data import png
from catre_tpu_torch.engine import runner
from catre_tpu_torch.entry import write_example_split
from catre_tpu_torch.geom.rotations import euler_to_mat

from test_torch_catre_loader import jax_draws
from torch_mirror import TorchCATRE, TorchConvOutPerRotHead

M, NPCL, H, W, N_IT, FRAMES = 4, 64, 120, 160, 2, 8
TABLE = np.random.default_rng(11).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
PRED_KEYS = ("pred_RTs", "pred_scales", "pred_class_ids", "pred_scores", "pred_bboxes")
NAME = "nocs_test_real"


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_example_split(str(tmp_path_factory.mktemp("split")), FRAMES, h=H, w=W, m=M,
                               seed=7)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-layout .pth whose rotation heads take 64 + 1024 points."""
    torch.manual_seed(5)
    model = TorchCATRE()
    model.rot_head = TorchConvOutPerRotHead(num_points=NPCL + 1024)
    path = str(tmp_path_factory.mktemp("weights") / "model.pth")
    torch.save({"model": model.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def init_json(split, tmp_path_factory):
    """Init estimates of every frame but frame 2: the gt poses moved by a few
    cm, scores falling with the slot, the masks and boxes of the split."""
    rng = np.random.default_rng(3)
    dets = {}
    for f, rec in enumerate(split):
        if f == 2:
            continue
        dets[rec["scene_im_id"]] = [
            {"obj_id": a["category_id"] + 1,
             "pose_est": (np.asarray(a["pose"]) + np.pad(rng.normal(0, 0.02, (3, 1)),
                                                          ((0, 0), (3, 0)))).tolist(),
             "scale_est": (np.asarray(a["scale"]) * rng.uniform(0.9, 1.1, 3)).tolist(),
             "score": 1.0 - 0.2 * j, "bbox_est": list(map(float, a["bbox_est"])),
             "segmentation": {"counts": [int(c) for c in a["segmentation"]["counts"]],
                              "size": list(a["segmentation"]["size"])}}
            for j, a in enumerate(rec["annotations"])]
    path = str(tmp_path_factory.mktemp("init") / "init_poses.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    return path


@pytest.fixture(autouse=True)
def _isolated(split, monkeypatch):
    """Both registries hold the split (fresh copies each call), both tables
    the seeded one, and the port's loader draws JAX's fields."""
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()
    fresh = functools.partial(copy.deepcopy, split)
    monkeypatch.setitem(jnocs._DATASET_REGISTRY, NAME, fresh)
    monkeypatch.setitem(tnocs._DATASET_REGISTRY, NAME, fresh)
    monkeypatch.setattr(jassets, "mean_shape_array", lambda *a, **k: TABLE)
    monkeypatch.setattr(tassets, "mean_shape_array", lambda *a, **k: TABLE)
    monkeypatch.setattr(runner, "CATRELoader", functools.partial(tl.CATRELoader,
                                                                 draws=jax_draws(0)))
    yield
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()


def _opts(out_dir, weights, extra=()):
    return [f"OUTPUT_DIR={out_dir}", f"MODEL.WEIGHTS={weights}", "SEED=0",
            f"INPUT.NUM_PCL={NPCL}", f"MODEL.CATRE.N_ITER_TEST={N_IT}", "MODEL.BF16=False",
            "MODEL.FUSED_HEADS=False", "MODEL.FUSED_HEADS_TRAIN=False",
            "MODEL.FUSED_ENCODER_TRAIN=False", "MODEL.LOAD_POSES_TEST=False",
            "TEST.IMS_PER_BATCH=2", f"DATALOADER.MAX_OBJS_PER_IMAGE={M}",
            "DATALOADER.NUM_WORKERS=0", *extra]


def _port_cfg(out_dir, weights, extra=()):
    return apply_overrides(load_config(str(FLAGSHIP_CONFIG)), _opts(out_dir, weights, extra))


def _jax_cfg(out_dir, weights, extra=()):
    return jax_apply_overrides(jax_load_config(str(FLAGSHIP_CONFIG)),
                               _opts(out_dir, weights, extra))


def _preds(out_dir):
    with open(os.path.join(out_dir, "predictions.pkl"), "rb") as f:
        return pickle.load(f)


def _same_preds(ours, ref, tol=5e-4):
    assert len(ours) == len(ref) == N_IT + 1
    for it, (a, b) in enumerate(zip(ours, ref)):
        assert sorted(a) == sorted(b) and a, it
        for sid in a:
            assert list(a[sid]) == list(b[sid]) == list(PRED_KEYS)
            for k in PRED_KEYS:
                x, y = a[sid][k], b[sid][k]
                assert x.dtype == y.dtype and x.shape == y.shape, (it, sid, k)
                if it == 0 or k not in ("pred_RTs", "pred_scales"):
                    assert x.tobytes() == y.tobytes(), (it, sid, k)
                else:
                    np.testing.assert_allclose(x, y, atol=tol, rtol=0, err_msg=f"{it} {sid} {k}")


def _same_tables(ours, ref, atol=0.0):
    assert sorted(ours) == sorted(ref)
    for it in ref:
        for k in ("iou_aps", "pose_aps"):
            np.testing.assert_allclose(ours[it][k], ref[it][k], atol=atol, rtol=0)
        assert list(ours[it]["summary"]) == list(ref[it]["summary"])
        np.testing.assert_allclose(list(ours[it]["summary"].values()),
                                   list(ref[it]["summary"].values()), atol=atol * 100, rtol=0)


def _both(tmp_path, weights, extra=()):
    """do_test of each package on the same config -> (port, jax) results."""
    ours = runner.do_test(_port_cfg(tmp_path / "port", weights, extra), device="cpu")
    ref = jrunner.do_test(_jax_cfg(tmp_path / "jax", weights, extra))
    return ours[NAME], ref[NAME]


CASES = {
    "est": (),
    "init_json": ("MODEL.LOAD_POSES_TEST=True", "DATASETS.DET_THR=0.5"),
    "init_json_keep_empty": ("MODEL.LOAD_POSES_TEST=True", "DATALOADER.FILTER_EMPTY_DETS=False"),
    "canonical": ("INPUT.INIT_POSE_TYPE_TEST=canonical",),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_do_test_matches_jax(case, tmp_path, weights, init_json):
    extra = CASES[case]
    if "MODEL.LOAD_POSES_TEST=True" in extra:
        extra = extra + (f"DATASETS.INIT_POSE_FILES_TEST=('{init_json}',)",)
    ours, ref = _both(tmp_path, weights, extra)
    _same_preds(_preds(tmp_path / "port"), _preds(tmp_path / "jax"))
    _same_tables(ours["results"], ref["results"])
    if "DATASETS.DET_THR=0.5" in extra:      # scores 1.0, 0.8, 0.6, 0.4: the last dropped
        assert max(len(p["pred_scores"]) for p in _preds(tmp_path / "port")[0].values()) == 3
    if case == "init_json":                  # frame 2 has no detections: scored empty
        sid = f"example/{2:04d}"
        assert sid not in _preds(tmp_path / "port")[0]
        assert len(ours["results"]) == N_IT + 1


def test_eval_cached_rescoring(tmp_path, weights):
    first = runner.do_test(_port_cfg(tmp_path / "port", weights), device="cpu")[NAME]
    cached = ("VAL.EVAL_CACHED=True",)
    again = runner.do_test(_port_cfg(tmp_path / "port", weights, cached), device="cpu")[NAME]
    assert again["stats"] == {}
    _same_tables(again["results"], first["results"], atol=1e-12)
    # JAX re-scores the port's predictions.pkl to the same tables
    ref = jrunner.do_test(_jax_cfg(tmp_path / "port", weights, cached))[NAME]
    _same_tables(ref["results"], first["results"], atol=1e-12)


def test_save_results_only(tmp_path, weights):
    ours, ref = _both(tmp_path, weights, ("TEST.SAVE_RESULTS_ONLY=True",))
    assert ours["results"] == {} == ref["results"]
    loaded = []
    for side in ("port", "jax"):
        with open(tmp_path / side / f"results_{NAME}.pkl", "rb") as f:
            loaded.append(pickle.load(f))
    a, b = loaded
    assert sorted(a) == sorted(b) and len(a) == FRAMES
    for sid in a:
        assert list(a[sid]) == list(b[sid])
        for k, v in b[sid].items():
            if k.startswith(("pred_RTs_", "pred_scales_")) and not k.endswith("_0"):
                np.testing.assert_allclose(a[sid][k], v, atol=5e-4, rtol=0)
            else:
                assert np.asarray(a[sid][k]).tobytes() == np.asarray(v).tobytes(), (sid, k)


def test_gt_noise_arithmetic_matches_jax():
    """The same noise through the override arguments gives JAX's poses and
    scales: the rotation clip at NOISE_ROT_MAX_TEST, the z floor and the
    scale clip included."""
    rng = np.random.default_rng(0)
    n = 64
    eul = rng.normal(0, 40, (n, 3)).astype(np.float32)
    dt = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    ds = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    poses = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
                            rng.uniform(-0.2, 0.5, (n, 3, 1)).astype(np.float32)], axis=2)
    scales = rng.uniform(0.05, 0.4, (n, 3)).astype(np.float32)
    ours = taug.aug_poses_normal(None, torch.from_numpy(poses), [15.0], [[0.01] * 3],
                                 max_rot=30.0, min_z=0.1, euler_deg_override=eul,
                                 trans_noise_override=dt)
    ref = jaug.aug_poses_normal(jax.random.PRNGKey(0), jnp.asarray(poses), jnp.asarray([15.0]),
                                jnp.asarray([[0.01] * 3]), max_rot=30.0, min_z=0.1,
                                euler_deg_override=eul, trans_noise_override=dt)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    ours = taug.aug_scale_normal(None, torch.from_numpy(scales), [[0.01] * 3], min_s=0.04,
                                 noise_override=ds)
    ref = jaug.aug_scale_normal(jax.random.PRNGKey(0), jnp.asarray(scales),
                                jnp.asarray([[0.01] * 3]), min_s=0.04, noise_override=ds)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-7, rtol=0)


def test_gt_noise_law():
    """`_add_gt_noise_init` on 4000 one-object images: the translation and
    scale noise have the std of the test ladders' rows, one row per image
    (their mean square per axis), the rotation noise is clipped per Euler
    axis at NOISE_ROT_MAX_TEST; scores 1, the gt kept; the draws repeat."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    apply_overrides(cfg, ["INPUT.NOISE_ROT_STD_TEST=60", "INPUT.NOISE_ROT_MAX_TEST=20"])
    n = 4000
    pose = np.concatenate([np.eye(3), [[0.0], [0.0], [1.0]]], axis=1).astype(np.float32)
    scale = np.full(3, 0.2, np.float32)

    def run():
        dicts = [{"annotations": [{"pose": pose, "scale": scale}]} for _ in range(n)]
        runner._add_gt_noise_init(cfg, dicts)
        return [d["annotations"][0] for d in dicts]

    annos = run()
    dt = np.stack([a["pose_est"][:, 3] - pose[:, 3] for a in annos])
    ds = np.stack([a["scale_est"] - scale for a in annos])
    for got, ladder in ((dt, cfg.INPUT.NOISE_TRANS_STD_TEST),
                        (ds, cfg.INPUT.NOISE_SCALE_STD_TEST)):
        want = np.sqrt(np.mean(np.square(np.asarray(ladder, np.float64)), axis=0))
        np.testing.assert_allclose(got.std(axis=0), want, rtol=0.08)
        np.testing.assert_allclose(got.mean(axis=0), 0.0, atol=4 * want.max() / np.sqrt(n))
    # the rotation noise: clipped at 20 degrees a Euler axis, so no rotation turns
    # further than the largest of the eight clipped corners, and (std 60) about
    # 0.74^3 of them sit on a corner
    def angle(R):
        tr = np.einsum("...ii->...", np.asarray(R, np.float64))
        return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))

    signs = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
    corners = angle(euler_to_mat(torch.deg2rad(torch.tensor(20.0 * signs,
                                                            dtype=torch.float32))).numpy())
    got = angle(np.stack([a["pose_est"][:, :3] for a in annos]))
    assert got.max() <= corners.max() + 1e-3
    on_corner = np.abs(got[:, None] - corners[None]).min(axis=1) < 1e-3
    assert 0.3 < on_corner.mean() < 0.5
    assert all(a["score"] == 1.0 and a["pose_est"].dtype == np.float32 for a in annos)
    again = run()
    assert all(np.array_equal(a["pose_est"], b["pose_est"]) for a, b in zip(annos, again))


def test_gt_noise_runs_through_do_test(tmp_path, weights, split):
    out = runner.do_test(_port_cfg(tmp_path, weights, ("INPUT.INIT_POSE_TYPE_TEST=gt_noise",)),
                         device="cpu")[NAME]
    preds = _preds(tmp_path)
    assert len(preds[0]) == FRAMES and sorted(out["results"]) == list(range(N_IT + 1))
    gt = {r["scene_im_id"]: r["annotations"] for r in split}
    moved = [np.abs(p["pred_RTs"][:, :3, 3] - np.stack([a["pose"][:, 3] for a in gt[sid]])).max()
             for sid, p in preds[0].items()]
    assert min(moved) > 0 and max(moved) < 0.2


def test_ctx_reuses_model_loader_and_refine(tmp_path, weights):
    cfg = _port_cfg(tmp_path, weights)
    ctx = {}
    runner.do_test(cfg, ctx=ctx, device="cpu")
    first = _preds(tmp_path)
    loaders = [v for k, v in ctx.items() if isinstance(k, tuple) and k[0] == "test_loader"]
    assert len(loaders) == 1 and "model" in ctx
    params = {k: v.clone() for k, v in ctx["model"].state_dict().items()}
    with pytest.raises(ValueError, match="params_override"):
        runner.do_test(cfg, ctx=ctx, device="cpu")
    runner.do_test(cfg, params_override=params, ctx=ctx, device="cpu")
    assert [v for k, v in ctx.items() if isinstance(k, tuple) and k[0] == "test_loader"] == loaders
    second = _preds(tmp_path)
    for a, b in zip(first, second):
        assert sorted(a) == sorted(b)
        for sid in a:
            for k in PRED_KEYS:
                assert a[sid][k].dtype == b[sid][k].dtype
                assert a[sid][k].tobytes() == b[sid][k].tobytes()


def test_what_the_port_refuses(tmp_path, weights):
    cfg = _port_cfg(tmp_path, weights)
    # NUM_CHIPS counts processes a machine: 2 in a process without a group of 2 raises
    with pytest.raises(ValueError, match="NUM_CHIPS=2 processes a machine"):
        runner.do_test(apply_overrides(cfg, ["NUM_CHIPS=2"]), device="cpu")
    with pytest.raises(ValueError, match="NUM_CHIPS=2 processes a machine"):
        runner.do_train(apply_overrides(cfg, ["NUM_CHIPS=2"]), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            runner.do_test(_port_cfg(tmp_path, weights))


def test_filter_invalid_dicts_matches_jax():
    dicts = [
        {"scene_im_id": "a", "annotations": [{"visib_fract": 0.05, "category_id": 1},
                                             {"visib_fract": 0.8, "category_id": 2}]},
        {"scene_im_id": "b", "annotations": [{"visib_fract": 0.1, "category_id": 1}]},
        {"scene_im_id": "c", "annotations": [{"category_id": 3}]},
        {"scene_im_id": "d"},
    ]
    for thr in (0.0, 0.3, 0.9):
        assert runner.filter_invalid_dicts(dicts, thr) == jrunner.filter_invalid_dicts(dicts, thr)
    assert len(dicts[0]["annotations"]) == 2


def test_canonical_init_matches_jax():
    cfg = load_config(str(FLAGSHIP_CONFIG))
    mk = lambda: [{"annotations": [{"pose": np.eye(3, 4, dtype=np.float32)}] * 2}]  # noqa: E731
    ours, ref = mk(), mk()
    runner._add_canonical_init(cfg, ours)
    jrunner._add_canonical_init(jax_load_config(str(FLAGSHIP_CONFIG)), ref)
    for a, b in zip(ours[0]["annotations"], ref[0]["annotations"]):
        np.testing.assert_allclose(a["pose_est"], b["pose_est"], atol=1e-6, rtol=0)
        assert a["scale_est"].tobytes() == b["scale_est"].tobytes() and a["score"] == b["score"]


# ---- the dataset registry

def _fake_real_split(root, n_scenes=2, n_frames=2, three_channel=False):
    """A NOCS REAL test split on disk: per frame a label pickle and an
    instance mask (ids 1..4, one instance too small, one box too thin)."""
    rng = np.random.default_rng(0)
    insts = ["bottle_red_stanford_norm", "bowl_shengjun_norm", "mug_daniel_norm",
             "laptop_air_xin_norm"]
    lines = []
    for s in range(n_scenes):
        os.makedirs(os.path.join(root, "real_test", f"scene_{s + 1}"), exist_ok=True)
        for f in range(n_frames):
            base = os.path.join(root, "real_test", f"scene_{s + 1}", f"{f:04d}")
            lines.append(f"real_test/scene_{s + 1}/{f:04d}")
            mask = np.full((48, 64), 255, np.uint8)
            mask[2:20, 3:30] = 1
            mask[25:45, 5:25] = 2
            mask[10:12, 40:42] = 3            # 4 pixels: filtered for its segmentation
            mask[30:46, 35:60] = 4
            png.write_png(base + "_mask.png",
                          np.stack([np.zeros_like(mask), np.zeros_like(mask), mask], -1)
                          if three_channel else mask)
            rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(4)])
            gt = {"class_ids": [1, 2, 6, 5], "instance_ids": [1, 2, 3, 4], "model_list": insts,
                  "bboxes": np.array([[2, 3, 20, 30], [25, 5, 45, 25], [10, 40, 12, 42],
                                      [30, 35, 46, 35.5]], np.float32),
                  "rotations": rot.astype(np.float32),
                  "translations": rng.normal(0, 0.3, (4, 3)).astype(np.float32),
                  "scales": rng.uniform(0.1, 0.3, 4).astype(np.float32)}
            with open(base + "_label.pkl", "wb") as fh:
                pickle.dump(gt, fh)
    with open(os.path.join(root, "real_test_list_all.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {k: rng.uniform(0.05, 0.3, 3).astype(np.float32) for k in insts}


def _same_records(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k, v in b.items():
            if k in ("annotations", "gt_annotations"):
                assert len(a[k]) == len(v)
                for x, y in zip(a[k], v):
                    assert list(x) == list(y)
                    for kk, vv in y.items():
                        if kk == "segmentation":
                            assert list(map(int, x[kk]["counts"])) == list(map(int, vv["counts"]))
                            assert list(x[kk]["size"]) == list(vv["size"])
                        else:
                            np.testing.assert_array_equal(np.asarray(x[kk]), np.asarray(vv))
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v))


@pytest.mark.parametrize("three_channel", [False, True])
def test_nocs_dataset_matches_jax(tmp_path, monkeypatch, three_channel):
    scales = _fake_real_split(str(tmp_path), three_channel=three_channel)
    monkeypatch.setattr(jassets, "load_abs_scales", lambda *a, **k: scales)
    monkeypatch.setattr(tassets, "load_abs_scales", lambda *a, **k: scales)
    counts = {}
    for objs in (None, ["bowl"]):
        kw = dict(objs=objs, use_cache=False, image_root=str(tmp_path))
        ours = tnocs.NOCSDataset(NAME, **kw)()
        _same_records(ours, jnocs.NOCSDataset(NAME, **kw)())
        counts[str(objs)] = [len(r["annotations"]) for r in ours]
    # the 4-pixel mug and the thin laptop are dropped
    assert counts == {"None": [2] * 4, "['bowl']": [1] * 4}


def test_load_init_poses_matches_jax(split, init_json):
    for thr in (0.0, 0.5):
        ours = tnocs.load_init_poses_into_dataset(copy.deepcopy(split), init_json, score_thr=thr)
        ref = jnocs.load_init_poses_into_dataset(copy.deepcopy(split), init_json, score_thr=thr)
        _same_records(ours, ref)
    assert ours[2]["annotations"] == []


def test_registry_takes_a_callable_and_default_splits():
    calls = []
    tnocs.register_dataset("written_split", lambda: calls.append(1) or [{"scene_im_id": "x"}])
    try:
        assert tnocs.get_dataset_dicts("written_split") == [{"scene_im_id": "x"}]
        assert calls == [1]
    finally:
        tnocs._DATASET_REGISTRY.pop("written_split")
    assert tnocs.DEFAULT_SPLITS == jnocs.DEFAULT_SPLITS
    saved = dict(tnocs._DATASET_REGISTRY)
    try:
        tnocs.register_default_splits()
        assert isinstance(tnocs._DATASET_REGISTRY["nocs_test_real_mug"], tnocs.NOCSDataset)
        assert tnocs._DATASET_REGISTRY["nocs_test_real_mug"].objs == ["mug"]
    finally:
        tnocs._DATASET_REGISTRY.clear()
        tnocs._DATASET_REGISTRY.update(saved)


# ---- TEST.VIS and the drawing it uses

def test_vis_drawing_matches_opencv():
    """The numpy JET map within 1 level of cv2.COLORMAP_JET; a projected box
    drawn where cv2.line draws it (each pixel within 1 of one of OpenCV's,
    and OpenCV's within 2 of ours); the tiling."""
    import cv2

    from catre_tpu_torch.utils import vis

    x = np.arange(256, dtype=np.uint8)[None]
    assert np.abs(vis.heatmap(x).astype(int)
                  - cv2.applyColorMap(x, cv2.COLORMAP_JET).astype(int)).max() <= 1
    d = np.random.default_rng(0).uniform(0.3, 2.0, (40, 50)).astype(np.float32)
    np.testing.assert_array_equal(vis.heatmap(d, to_rgb=True), vis.heatmap(d)[:, :, ::-1])
    K = np.array([[150.0, 0, 80], [0, 150, 60], [0, 0, 1]])
    kernel = np.ones((3, 3), np.uint8)
    for pose_t, scale in (((0, 0, 1.0), (0.3, 0.2, 0.25)), ((0.4, -0.3, 0.8), (0.6, 0.5, 0.4))):
        pose = np.concatenate([np.eye(3), np.asarray(pose_t)[:, None]], axis=1)
        ours = vis.draw_projected_box3d(np.zeros((120, 160, 3), np.uint8), scale, pose, K)
        ref = np.zeros((120, 160, 3), np.uint8)
        uv = vis.project(vis.get_3d_bbox(scale).T, K, pose).round().astype(int)
        for a, b in vis._EDGES:
            cv2.line(ref, tuple(map(int, uv[a])), tuple(map(int, uv[b])), (0, 255, 0), 2)
        mo, mr = ours.any(2).astype(np.uint8), ref.any(2).astype(np.uint8)
        assert mo.sum() > 100 and (ours[mo > 0] == (0, 255, 0)).all()
        assert not (mo & ~cv2.dilate(mr, kernel).astype(bool)).any()
        assert not (mr & ~cv2.dilate(mo, kernel, iterations=2).astype(bool)).any()
    grid = vis.grid_show([np.zeros((10, 20, 3), np.uint8)] * 3, row=2, col=2)
    assert grid.shape == (24, 44, 3) and (grid[:10, :20] == 0).all() and (grid[14:, 24:] == 255).all()


def test_test_vis_writes_the_panels(tmp_path, weights):
    runner.do_test(_port_cfg(tmp_path, weights, ("TEST.VIS=True",)), device="cpu")
    files = sorted(os.listdir(tmp_path / "vis"))
    assert len(files) == 10 and files[0] == "example_0000.png" and files[1] == "example_0000_iters.png"
    overlay = png.read_png(str(tmp_path / "vis" / files[0]))
    panels = png.read_png(str(tmp_path / "vis" / files[1]))
    assert overlay.shape == (H, W, 3) and panels.shape == (H, 2 * W + 4, 3)
    # the boxes are drawn: pure green (the final estimate) on the overlay
    assert ((overlay == (0, 255, 0)).all(axis=2)).sum() > 50


def test_dataset_vis_harness(tmp_path, monkeypatch):
    monkeypatch.setattr(tnocs, "_DATASET_REGISTRY", dict(tnocs._DATASET_REGISTRY))
    assert tnocs._vis_main([NAME, "--num", "2", "--skip", "1", "--out", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path))
    assert files == ["example_0001.png", "example_0002.png"]
    grid = png.read_png(str(tmp_path / files[0]))
    assert grid.shape == (2 * H + 4, 2 * W + 4, 3)
    assert ((grid[:H, W + 4:] == (0, 0, 255)).all(axis=2)).sum() > 20   # box edges, red in BGR
