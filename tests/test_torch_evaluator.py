"""The port's evaluator (`catre_tpu_torch/eval/evaluator.py`) against the JAX
package's on the CPU, on a split written by `entry.write_example_split` (8
frames of 120 x 160, 4 slots; frame 2 keeps its ground truth but has no
detections, so the loaders skip it and the evaluator scores it empty).

- `CATREEvaluator`: the same predictions give tables bit-equal to JAX's, and
  each package's `predictions.pkl` re-scores identically in the other.
- `run_inference`: both loaders read the split (the JAX mean-shape table
  patched to a seeded one, the port drawing JAX's priority fields: see
  `tests/test_torch_catre_loader.py`), the plain f32 refine on both sides with
  the JAX weights carried by `params_from_jax`. Iteration 0 exact, class ids,
  scores and boxes equal, refined poses and scales within 5e-4
  (`tests/test_fused_refine.py`'s tolerance), every dtype equal.
- Mirrors of `tests/test_evaluator.py` (which needs OpenCV and the NOCS
  pickles): ims 1 vs 2, the two input paths, noisy init, the padded final
  group, warm-up accounting, probe keys; and what the port refuses."""

import pickle

import numpy as np
import pytest
import torch

import jax

from catre_tpu.data import assets as jassets
from catre_tpu.data import loader as jl
from catre_tpu.engine.refiner import make_refine_fn as jax_make_refine_fn
from catre_tpu.eval import evaluator as jev
from catre_tpu.models import CATREConfig as JaxConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.models import init_params
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.engine.refiner import make_refine_fn
from catre_tpu_torch.entry import evaluate_split, loader_refine_args, write_example_split
from catre_tpu_torch.eval import evaluator as tev
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.utils.convert import params_from_jax

from test_torch_catre_loader import jax_draws

M, NPCL, H, W, N_IT = 4, 64, 120, 160, 2
TABLE = np.random.default_rng(11).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
PRED_KEYS = ("pred_RTs", "pred_scales", "pred_class_ids", "pred_scores", "pred_bboxes")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    recs = write_example_split(str(tmp_path_factory.mktemp("split")), 8, h=H, w=W, m=M, seed=7)
    recs[2] = dict(recs[2], annotations=[])        # no detections; the ground truth stays
    return recs


@pytest.fixture(autouse=True)
def _fresh_registry():
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()
    yield
    tl.clear_decoded_caches()
    jl._DECODED_CACHE_REGISTRY.clear()


@pytest.fixture(scope="module")
def models():
    """JAX (model, params, refine) and the port's refine over the same weights,
    the plain f32 path on both sides."""
    jcfg = JaxConfig(num_pcl=NPCL, num_kps=1024)
    jmodel = JaxModel(jcfg)
    params = init_params(jmodel, jcfg, jax.random.PRNGKey(0))
    model = init_model(CATREConfig(num_pcl=NPCL, num_kps=1024), seed=1)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.array, params), model))
    return jax_make_refine_fn(jmodel, jcfg, n_iter=N_IT), params, make_refine_fn(model, N_IT)


def _lcfg(**kw):
    f = dict(num_pcl=NPCL, depth_sample_ball_ratio=0.6, sample_window=-1, aug_depth=False,
             max_objs_per_image=M, cache_decoded="device")
    f.update(kw)
    return f


def _port_loader(split, ims=2, **kw):
    lkw = {k: kw.pop(k) for k in list(kw) if k in tl.LoaderConfig.__dataclass_fields__}
    kw.setdefault("mean_points", TABLE)
    kw.setdefault("device_batches", True)
    return tl.CATRELoader(split, tl.LoaderConfig(**_lcfg(**lkw)), phase="test",
                          ims_per_batch=ims, device="cpu", **kw)


def _port_run(split, refine, ims=2, loader_kw=None, **kw):
    ev = tev.CATREEvaluator(split, n_iters=N_IT)
    kw = {"warmup": 0, "mean_table": TABLE, **kw}
    stats = tev.run_inference(refine, _port_loader(split, ims, **(loader_kw or {})), ev, N_IT,
                              **kw)
    return stats, ev


@pytest.fixture(scope="module")
def jax_run(split, models):
    """JAX's loader -> refine -> evaluator on the split, mean table patched."""
    jrefine, params, _ = models
    mp = pytest.MonkeyPatch()
    mp.setattr(jassets, "mean_shape_array", lambda *a, **k: TABLE)
    try:
        loader = jl.CATRELoader(split, jl.LoaderConfig(**_lcfg()), phase="test",
                                ims_per_batch=2, device_batches=True)
        ev = jev.CATREEvaluator(split, n_iters=N_IT)
        stats = jev.run_inference(jrefine, params, iter(loader), ev, n_iters=N_IT, warmup=0)
    finally:
        mp.undo()
        jl._DECODED_CACHE_REGISTRY.clear()
    return stats, ev


@pytest.fixture(scope="module")
def port_run(split, models):
    tl.clear_decoded_caches()
    out = _port_run(split, models[2], loader_kw={"draws": jax_draws(0)})
    tl.clear_decoded_caches()
    return out


def _rand_preds(split, seed):
    """Random per-image predictions around the ground truth for every
    iteration, in run_inference's dtypes."""
    rng = np.random.default_rng(seed)
    preds = [dict() for _ in range(N_IT + 1)]
    for it in range(N_IT + 1):
        for rec in split[:-1]:                              # the last image gets none
            annos = rec["gt_annotations"]
            pose = np.stack([a["pose"] for a in annos]).astype(np.float32)
            pose[:, :, 3] += rng.normal(0, 0.02 * it, (len(annos), 3)).astype(np.float32)
            p44 = np.concatenate([pose, np.tile(np.float32([[[0, 0, 0, 1]]]), (len(annos), 1, 1))],
                                 axis=1)
            preds[it][rec["scene_im_id"]] = {
                "pred_RTs": p44,
                "pred_scales": np.stack([a["scale"] for a in annos]).astype(np.float32),
                "pred_class_ids": np.int32([a["category_id"] + 1 for a in annos]),
                "pred_scores": rng.uniform(0.3, 1, len(annos)).astype(np.float32),
                "pred_bboxes": np.float32([a["bbox"] for a in annos])[:, [1, 0, 3, 2]]}
    return preds


def _same_tables(ours, ref):
    assert sorted(ours) == sorted(ref)
    for it in ref:
        for k in ("iou_aps", "pose_aps"):
            x, y = ours[it][k], ref[it][k]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (it, k)
        assert list(ours[it]["summary"]) == list(ref[it]["summary"])
        for k, v in ref[it]["summary"].items():
            w = ours[it]["summary"][k]
            assert type(w) is type(v) and (w == v or (np.isnan(w) and np.isnan(v))), (it, k)


def _same_preds(ours, ref, exact_iters=None, tol=5e-4):
    assert len(ours) == len(ref)
    for it, (a, b) in enumerate(zip(ours, ref)):
        assert sorted(a) == sorted(b) and a, it
        for sid in a:
            assert list(a[sid]) == list(b[sid]) == list(PRED_KEYS)
            for k in PRED_KEYS:
                x, y = a[sid][k], b[sid][k]
                assert x.dtype == y.dtype and x.shape == y.shape, (it, sid, k, x.dtype, y.dtype)
                if exact_iters is None or it in exact_iters or k not in ("pred_RTs",
                                                                           "pred_scales"):
                    assert x.tobytes() == y.tobytes(), (it, sid, k)
                else:
                    np.testing.assert_allclose(x, y, atol=tol, rtol=0, err_msg=f"{it} {sid} {k}")


# ---- CATREEvaluator

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_tables_bit_equal_to_jax(split, seed):
    preds = _rand_preds(split, seed)
    tables = []
    for mod in (tev, jev):
        ev = mod.CATREEvaluator(split, n_iters=N_IT)
        for it, per_image in enumerate(preds):
            for sid, p in per_image.items():
                ev.process(sid, it, p["pred_RTs"], p["pred_scales"], p["pred_class_ids"],
                           p["pred_scores"], p["pred_bboxes"])
        tables.append(ev.evaluate(dump=False))
        assert len(tables[-1]) == N_IT + 1
    _same_tables(*tables)


def test_gts_match_jax(split):
    ours, ref = tev.CATREEvaluator._build_gts(split), jev.CATREEvaluator._build_gts(split)
    assert list(ours) == list(ref) and len(ours) == len(split)
    for sid in ref:
        for k, v in ref[sid].items():
            assert ours[sid][k].dtype == v.dtype and ours[sid][k].tobytes() == v.tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_predictions_pkl_rescores_in_the_other_package(split, tmp_path, writer):
    """do_test's EVAL_CACHED path: one package's predictions.pkl, loaded into
    the other's evaluator, scores as the writer scored it; the dumped tables
    read the same."""
    mods = {"port": tev, "jax": jev}
    reader = "jax" if writer == "port" else "port"
    src = mods[writer].CATREEvaluator(split, n_iters=N_IT, output_dir=str(tmp_path / "w"))
    src._preds = _rand_preds(split, 5)
    ref = src.evaluate()
    dst = mods[reader].CATREEvaluator(split, n_iters=N_IT, output_dir=str(tmp_path / "r"))
    with open(tmp_path / "w" / "predictions.pkl", "rb") as f:
        dst._preds = pickle.load(f)
    _same_tables(dst.evaluate(), ref)
    for it in range(N_IT + 1):
        name = f"metrics_tab_iter{it}.txt"
        assert (tmp_path / "w" / name).read_text() == (tmp_path / "r" / name).read_text()


# ---- run_inference against JAX

def test_run_inference_matches_jax(jax_run, port_run):
    (jstats, jev_), (stats, ev) = jax_run, port_run
    assert set(stats) == set(jstats) and stats["images"] == jstats["images"] == 7
    _same_preds(ev._preds, jev_._preds, exact_iters={0})
    assert "example/0002" not in ev._preds[0] and len(ev._preds[0]) == 7
    ours, ref = ev.evaluate(dump=False), jev_.evaluate(dump=False)
    _same_tables({0: ours[0]}, {0: ref[0]})
    # init = gt: 100 on every class over the images with detections; the
    # image without any counts as missed
    detected = tev.CATREEvaluator([], n_iters=N_IT)
    detected._gts = {k: g for k, g in ev._gts.items() if k in ev._preds[0]}
    detected._preds = ev._preds
    at_init = detected.evaluate(dump=False)[0]
    present = sorted({int(c) for g in detected._gts.values() for c in g["gt_class_ids"]})
    assert present
    for c in present:
        assert at_init["iou_aps"][c, 1:].min() >= 1 - 1e-9
        assert at_init["pose_aps"][c, 0, 0] >= 1 - 1e-9 and at_init["pose_aps"][c, -1, 0] >= 1 - 1e-9
    for c in ev._gts["example/0002"]["gt_class_ids"]:
        assert ours[0]["iou_aps"][c, 1] < 1.0
    for it in (1, 2):
        assert all(np.isfinite(v) for v in ours[it]["summary"].values())


# ---- mirrors of tests/test_evaluator.py

def test_ims_1_and_2_give_the_same_scores(split, models):
    results = {}
    for ims in (1, 2):
        _, ev = _port_run(split, models[2], ims)
        results[ims] = ev.evaluate(dump=False)
    for it in range(N_IT + 1):
        for k in ("iou_aps", "pose_aps"):
            np.testing.assert_allclose(results[1][it][k], results[2][it][k], atol=1e-9)


def test_input_paths_are_bit_equal_to_the_packed_path(split, models):
    _, packed = _port_run(split, models[2], loader_kw={"ship_mean_points": False})
    # the table's rows shipped per object, as for USE_CMRA_MODEL priors
    _, other = _port_run(split, models[2], loader_kw={"ship_mean_points": True},
                         use_mean_table=False)
    _same_preds(other._preds, packed._preds)


def test_noisy_init_scores_degrade(split, models):
    rng = np.random.default_rng(0)
    noisy = [dict(r, annotations=[dict(a, pose_est=a["pose_est"].copy())
                                  for a in r["annotations"]]) for r in split]
    for r in noisy:
        for a in r["annotations"]:
            a["pose_est"][:, 3] += rng.normal(0, 0.1, 3).astype(np.float32)
    _, ev = _port_run(noisy, models[2])
    res = ev.evaluate(dump=False)
    assert res[0]["summary"]["te2"] < 100.0 and res[0]["pose_aps"][-1, -1, 0] < 1.0


def test_final_partial_group_is_padded(split, models):
    """ims 4 over 7 images with detections: the last group is padded to the
    full shape, its padding skipped; the image without detections is scored
    with empty predictions; scores equal the per-image run."""
    batches = [b for b in _port_loader(split, 4) if not b.get("empty")]
    assert {tuple(b["pcl"].shape) for b in batches} == {(16, NPCL, 3)}
    assert batches[-1]["scene_im_ids"][-1] is None
    results = {}
    for ims in (1, 4):
        ev = tev.CATREEvaluator(split, n_iters=N_IT)
        stats = tev.run_inference(models[2], [b for b in _port_loader(split, ims)
                                              if not b.get("empty")],
                                  ev, N_IT, warmup=0, mean_table=TABLE, device="cpu")
        assert stats["images"] == 7 and "example/0002" in ev._gts
        assert all("example/0002" not in p and None not in p for p in ev._preds)
        results[ims] = ev.evaluate(dump=False)
    for it in range(N_IT + 1):
        for k in ("iou_aps", "pose_aps"):
            np.testing.assert_allclose(results[1][it][k], results[4][it][k], atol=1e-9)


def test_warmup_accounting(split, models):
    """The warm-up batch is left out of the timing counts, not out of the
    predictions."""
    stats, ev = _port_run(split, models[2], warmup=1)
    assert stats["images"] == 5                    # 7 images, the first group's 2 not timed
    assert all(len(p) == 7 for p in ev._preds) and stats["compute_s_per_img"] > 0


@pytest.mark.parametrize("probe_every,prefetch", [(1, 2), (2, 0), (0, 1)])
def test_probe_keys_and_prefetch(split, models, port_run, probe_every, prefetch):
    stats, ev = _port_run(split, models[2], loader_kw={"draws": jax_draws(0)},
                          compute_probe_every=probe_every, prefetch=prefetch)
    assert set(stats) == {"images", "total_s", "compute_s_per_img", "overlap_fetch_s_per_img",
                          "process_s_per_img"}
    assert stats["compute_s_per_img"] > 0 and stats["overlap_fetch_s_per_img"] >= 0
    _same_preds(ev._preds, port_run[1]._preds)


def test_loader_refine_args_unpack_the_packed_row(split):
    """One packer: phase 5d's `entry.loader_refine_args` sends the (B, 28) row
    of `pack_host`, and unpacking it gives each field back, contiguous."""
    b = next(x for x in _port_loader(split) if not x.get("empty"))
    packed = tev.pack_host(b)
    assert packed.shape == (2 * M, 28) and packed.dtype == torch.float32
    args = loader_refine_args(b, torch.from_numpy(TABLE))
    for got, want in zip(args[2:], (b["obj_pose_est"], b["obj_scale_est"], b["K"],
                                    b["obj_mean_scales"])):
        assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    assert np.array_equal(args[1].numpy(), TABLE[b["obj_cls"]])


def test_evaluate_split_scores_the_split(split, port_run):
    """The entry point over the shipped loader and refine (bf16 plain versions
    here): iteration 0, a function of the init alone, scores as above."""
    stats, results = evaluate_split(split, "cpu", TABLE, n_iters=1, num_pcl=32,
                                    max_objs_per_image=M, ims_per_batch=2, num_workers=2,
                                    warmup=0)
    assert stats["images"] == 7 and stats["score_s"] > 0 and sorted(results) == [0, 1]
    _same_tables({0: results[0]}, {0: port_run[1].evaluate(dump=False)[0]})
    assert all(np.isfinite(v) for v in results[1]["summary"].values())


# ---- refusals

def test_run_inference_refuses_what_it_does_not_do(split, models):
    refine = models[2]
    ev = tev.CATREEvaluator(split, n_iters=N_IT)
    batches = [b for b in _port_loader(split) if not b.get("empty")]
    with pytest.raises(NotImplementedError, match="item 15"):       # one process per card
        tev.run_inference(refine, batches, ev, N_IT, mesh=object(), mean_table=TABLE)
    with pytest.raises(NotImplementedError, match="item 15"):
        tev.run_inference(refine, [dict(batches[0], _presampled={})], ev, N_IT,
                          mean_table=TABLE, device="cpu")
    bare = [b for b in _port_loader(split, ship_mean_points=False) if not b.get("empty")]
    with pytest.raises(ValueError, match="ship_mean_points=True"):
        tev.run_inference(refine, bare, ev, N_IT, use_mean_table=False, device="cpu")
    with pytest.raises(ValueError, match="obj_fps_points"):
        tev.run_inference(refine, batches, ev, N_IT, kps_type="fps", device="cpu")
    with pytest.raises(ValueError, match="needs device="):
        tev.run_inference(refine, batches, ev, N_IT, mean_table=TABLE)
    with pytest.raises(ValueError, match="one device"):
        tev.run_inference(refine, _port_loader(split), ev, N_IT, mean_table=TABLE, device="meta")
    with pytest.raises(ValueError, match="one device"):
        tev.run_inference(refine, batches, ev, N_IT, mean_table=TABLE, device="meta")
    # the refine's model elsewhere than the loader: its first layer refuses the inputs
    meta_refine = make_refine_fn(init_model(CATREConfig(num_pcl=NPCL), device="meta"), N_IT)
    with pytest.raises(RuntimeError, match="device"):
        tev.run_inference(meta_refine, _port_loader(split), ev, N_IT, mean_table=TABLE)


def test_missing_asset_table_falls_back_to_the_host_path(split, models, monkeypatch, tmp_path):
    """No mean_table and no asset file: the per-batch host path, which reads
    the shipped mean points (JAX :279-292)."""
    from catre_tpu_torch.data import assets as tassets

    monkeypatch.setattr(tassets, "mean_shape_array",
                        lambda path=str(tmp_path / "mean.pkl"): tassets.load_mean_shapes(path))
    _, packed = _port_run(split, models[2], loader_kw={"ship_mean_points": False})
    ev = tev.CATREEvaluator(split, n_iters=N_IT)
    tev.run_inference(models[2], _port_loader(split, ship_mean_points=True), ev, N_IT, warmup=0)
    _same_preds(ev._preds, packed._preds)
    with pytest.raises(ValueError, match="ship_mean_points=True"):
        tev.run_inference(models[2], _port_loader(split, ship_mean_points=False), ev, N_IT)

