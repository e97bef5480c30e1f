"""The port's synthetic split, training soak and sampler study
(`catre_tpu_torch/tools/{synth_nocs,soak,sampler_spread}.py`) against the
JAX package's.

- `generate_split`: 3 frames of each shape from the same seed; the PNGs
  decode to the JAX tool's pixels (the JAX tool writes with OpenCV), the label
  pickles and the list file are equal.
- `soak`: the config each tool hands to `do_train` (both recorded) is equal
  key by key, and so are the registered splits and the data written.
- `sampler_spread`: `inject_fixed_init` bit-equal to JAX's; one run of the
  port's study at 4 frames, 2 seeds, NUM_PCL 64, one iteration, no arm B, on
  the CPU: its report has the JAX report's keys and its iteration-0 tables do
  not move with the seed; arm B without the reference checkout and an
  unknown dtype arm raise. (The dtype study runs on the card, in
  `chip_smoke.py` phase 8.)

The mean-shape table and the abs-scale table are seeded stand-ins patched
into both packages' `assets` (the asset pickles are not on this host)."""

import copy
import json
import pickle

import numpy as np
import pytest

import jax

from catre_tpu.data import assets as jassets
from catre_tpu.engine import runner as jrunner
from catre_tpu.tools import sampler_spread as jspread
from catre_tpu.tools import soak as jsoak
from catre_tpu.tools import synth_nocs as jsynth
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import meta as tmeta
from catre_tpu_torch.data import nocs as tnocs
from catre_tpu_torch.data import png
from catre_tpu_torch.engine import runner as trunner
from catre_tpu_torch.tools import sampler_spread as tspread
from catre_tpu_torch.tools import soak as tsoak
from catre_tpu_torch.tools import synth_nocs as tsynth

TABLE = (np.random.default_rng(11).normal(size=(6, 1024, 3)) * 0.15).astype(np.float32)
SCALES = {f"{obj}_{i}_norm": np.random.default_rng(i).uniform(0.05, 0.3, 3).astype(np.float32)
          for i, obj in enumerate(["bottle", "bowl", "camera", "can", "laptop", "mug"] * 2)}


@pytest.fixture(autouse=True)
def _tables(monkeypatch, tmp_path):
    for mod in (jassets, tassets):
        monkeypatch.setattr(mod, "mean_shape_array", lambda *a, **k: TABLE)
        monkeypatch.setattr(mod, "load_abs_scales", lambda *a, **k: SCALES)
    monkeypatch.setenv("CATRE_CACHE_DIR", str(tmp_path / "cache"))


def _same_split(port_root, jax_root, split):
    a = (port_root / f"{split}_list_all.txt").read_text()
    assert a == (jax_root / f"{split}_list_all.txt").read_text() and a.strip()
    import cv2

    for rel in a.split():
        for suffix in ("depth", "mask", "color"):
            ours = png.read_png(f"{port_root}/{rel}_{suffix}.png")
            ref = cv2.imread(f"{jax_root}/{rel}_{suffix}.png", cv2.IMREAD_UNCHANGED)
            assert ours.dtype == ref.dtype and np.array_equal(ours, ref), (rel, suffix)
            assert np.array_equal(png.read_png(f"{jax_root}/{rel}_{suffix}.png"), ref)
        la = pickle.loads((port_root / f"{rel}_label.pkl").read_bytes())
        lb = pickle.loads((jax_root / f"{rel}_label.pkl").read_bytes())
        assert list(la) == list(lb)
        for k in lb:
            assert len(la[k]) == len(lb[k]) > 0, k
            for x, y in zip(la[k], lb[k]):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), (rel, k)


@pytest.mark.parametrize("split,shape", [("real_train", "mean"), ("val", "box")])
def test_generate_split_matches_jax(tmp_path, split, shape):
    pytest.importorskip("cv2")
    for mod, name in ((tsynth, "port"), (jsynth, "jax")):
        assert mod.generate_split(str(tmp_path / name), split=split, n_frames=3, n_objs=4,
                                  seed=5, shape=shape) == str(tmp_path / name)
    _same_split(tmp_path / "port", tmp_path / "jax", split)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_soak_hands_do_train_the_jax_config(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    seen = {}

    def record(which):
        def fake(cfg, resume=False, device=None):
            seen[which] = (copy.deepcopy(dict(cfg)), resume, device, tmeta.DATA_ROOT)
        return fake

    monkeypatch.setattr(jrunner, "do_train", record("jax"))
    monkeypatch.setattr(trunner, "do_train", record("port"))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)   # its compile cache
    monkeypatch.setattr(jsoak, "_DATASET_REGISTRY", {})
    monkeypatch.setattr(tnocs, "_DATASET_REGISTRY", {})
    monkeypatch.delenv("CATRE_DATA_ROOT", raising=False)
    old_root = tmeta.DATA_ROOT
    out = str(tmp_path / "out")
    args = ["--out", out, "--epochs", "3", "--frames", "2", "--frames2", "1",
            "--frames-test", "1", "--resume", "--opts", "TEST.EVAL_PERIOD=7", "SEED=4"]
    try:
        assert tsoak.main(["--data-root", str(tmp_path / "port"), "--device", "cpu", *args]) == 0
    finally:
        tmeta.set_data_root(old_root)
    assert jsoak.main(["--data-root", str(tmp_path / "jax"), *args]) == 0
    port, ref = _flat(seen["port"][0]), _flat(seen["jax"][0])
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k] == ref[k], k
    assert port["SOLVER.TOTAL_EPOCHS"] == 3 and port["TEST.EVAL_PERIOD"] == 7
    assert port["SEED"] == 4 and port["OUTPUT_DIR"] == out
    assert seen["port"][1:] == (True, "cpu", str(tmp_path / "port"))
    assert seen["jax"][1] is True
    assert sorted(tnocs._DATASET_REGISTRY) == sorted(jsoak._DATASET_REGISTRY)
    for name, ds in jsoak._DATASET_REGISTRY.items():
        ours = tnocs._DATASET_REGISTRY[name]
        assert ours.image_root.replace("/port/", "/jax/") == ds.image_root
        assert (ours.split, ours.use_cache) == (ds.split, ds.use_cache)
    for sub, split in (("REAL", "real_train"), ("CMRA", "train"), ("REAL", "real_test")):
        _same_split(tmp_path / "port" / sub, tmp_path / "jax" / sub, split)


@pytest.fixture(scope="module")
def spread_dicts():
    return [{"annotations": [{"pose": np.concatenate([np.eye(3), [[0.1], [0.0], [1.0]]], 1)
                              * (1 + 0.1 * i), "scale": np.full(3, 0.1 + j * 0.01, np.float32),
                              "bbox": [1.0, 2.0, 30.0, 40.0]} for j in range(3)]}
            for i in range(4)]


def test_inject_fixed_init_bit_equal_to_jax(spread_dicts):
    ours = tspread.inject_fixed_init(copy.deepcopy(spread_dicts), seed=5)
    ref = jspread.inject_fixed_init(copy.deepcopy(spread_dicts), seed=5)
    for ra, rb in zip(ours, ref):
        for a, b in zip(ra["annotations"], rb["annotations"]):
            assert sorted(a) == sorted(b)
            for k in ("pose_est", "scale_est"):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            assert a["bbox_est"] == b["bbox_est"] and a["score"] == b["score"] == 1.0
    for w in (np.zeros(3), np.array([0.3, -0.2, 0.9])):
        assert np.array_equal(tspread._rodrigues(w), jspread._rodrigues(w))


# the keys of the JAX tool's report (`catre_tpu/tools/sampler_spread.py:375-387`)
REPORT_KEYS = {"frames", "seeds", "ref_seeds", "ckpt", "n_iters", "iter0_max_ptp", "iter0", "ours"}


def test_sampler_spread_run(tmp_path):
    out = tmp_path / "study"
    argv = ["--out", str(out), "--frames", "4", "--seeds", "2", "--num-pcl", "64",
            "--n-iters", "1", "--ref-seeds", "0", "--ims-per-batch", "4", "--device", "cpu"]
    report = tspread.run_study(tspread.parse_args(argv))
    assert json.loads((out / "sampler_spread.json").read_text()) == json.loads(json.dumps(report))
    assert (out / "sampler_spread.md").read_text().startswith("| metric |")
    assert set(report) == REPORT_KEYS
    assert report["iter0_max_ptp"] == 0.0 and report["frames"] == 4 and report["seeds"] == 2
    assert report["iter0"]["IoU25"] > 50.0          # the fixed inits score high
    assert set(report["ours"]["IoU50"]) == {"mean", "std", "min", "max"}
    with pytest.raises(FileNotFoundError, match="cat_data_utils.py"):
        tspread.run_study(tspread.parse_args(argv + ["--ref-seeds", "1", "--ref-root",
                                                     str(tmp_path / "no_ref")]))
    with pytest.raises(ValueError, match="unknown dtype arm"):
        tspread.run_study(tspread.parse_args(argv + ["--dtype-arms", "f32,fp8"]))
