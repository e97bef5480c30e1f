"""The train step's input from a split on disk: `config/build.py::
loader_config_from(cfg, "train")`, `engine/runner.py::batch_to_device` and
`get_train_dicts` against the JAX package's (`catre_tpu/config/build.py`
:203, `catre_tpu/engine/runner.py` :124-188), and the entry points
`entry.shipped_train_loader` / `train_from_split` on small frames (120 x
160, 4 slots, 64 points), with and without JAX importable."""

import dataclasses
import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from catre_tpu.config.build import loader_config_from as j_loader_config_from
from catre_tpu.config.loader import load_config as j_load_config
from catre_tpu.data import nocs as jnocs
from catre_tpu.engine import runner as jrunner
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG, loader_config_from
from catre_tpu_torch.config.loader import load_config
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import nocs as tnocs
from catre_tpu_torch.engine import runner as trunner
from catre_tpu_torch.entry import shipped_train_loader, train_from_split, write_example_split

ROOT = Path(__file__).resolve().parents[1]
M, NPCL, NKPS, H, W = 4, 64, 64, 120, 160
TABLE = np.random.default_rng(3).normal(size=(6, NKPS, 3)).astype(np.float32) * 0.1
SMALL = dict(mean_points=TABLE, num_pcl=NPCL, num_kps=NKPS, max_objs_per_image=M,
             ims_per_batch=2, num_workers=2)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_example_split(str(tmp_path_factory.mktemp("split")), 5, h=H, w=W, m=M, seed=2)


@pytest.fixture(autouse=True)
def _fresh_registry():
    tl.clear_decoded_caches()
    yield
    tl.clear_decoded_caches()


VARIANTS = {
    "shipped": {},
    "repeat_factors": {"DATALOADER.SAMPLER_TRAIN": "RepeatFactorTrainingSampler",
                       "DATALOADER.REPEAT_THRESHOLD": 0.3},
    "last_frame": {"INPUT.INIT_POSE_TYPE_TRAIN": ["gt_noise", "last_frame"],
                   "INPUT.INIT_POSE_TRAIN_PATH": "/data/last_frame.pkl"},
    "path_without_last_frame": {"INPUT.INIT_POSE_TRAIN_PATH": "/data/last_frame.pkl"},
    "rgb_uncached": {"INPUT.PCL_WITH_COLOR": True, "DATALOADER.CACHE_DECODED": "",
                     "INPUT.COLOR_AUG_TYPE": "code", "INPUT.BG_TYPE": "VOC"},
    "no_aug_fps": {"INPUT.AUG_DEPTH": False, "INPUT.KPS_TYPE": "fps", "INPUT.SAMPLE_WINDOW": 128},
}


def _set(cfg, dotted: dict):
    for path, value in dotted.items():
        node = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loader_config_from_train_matches_jax(variant):
    for phase in ("train", "test"):
        port = loader_config_from(_set(load_config(str(FLAGSHIP_CONFIG)), VARIANTS[variant]),
                                  phase)
        ref = j_loader_config_from(_set(j_load_config(str(FLAGSHIP_CONFIG)), VARIANTS[variant]),
                                   phase)
        for field in dataclasses.fields(port):
            assert getattr(port, field.name) == getattr(ref, field.name), (phase, field.name)
    assert port.aug_depth is False          # the test phase never augments
    train = loader_config_from(_set(load_config(str(FLAGSHIP_CONFIG)), VARIANTS[variant]))
    assert train.init_pose_train_path == ("/data/last_frame.pkl" if variant == "last_frame"
                                          else "")
    assert train.aug_depth == (variant != "no_aug_fps")


def _batch(rows, valid_rows, kps_type="mean_shape", seed=0):
    rng = np.random.default_rng(seed)
    b = {"pcl": rng.normal(size=(rows, NPCL, 3)).astype(np.float32),
         "obj_cls": rng.integers(0, 6, rows).astype(np.int32),
         "obj_pose": rng.normal(size=(rows, 3, 4)).astype(np.float32),
         "obj_scale": rng.uniform(0.05, 0.3, (rows, 3)).astype(np.float32),
         "sym_flag": rng.random(rows) < 0.3, "valid": np.arange(rows) < valid_rows,
         "obj_mean_points": rng.normal(size=(rows, NKPS, 3)).astype(np.float32),
         "obj_mean_scales": rng.uniform(0.1, 0.3, (rows, 3)).astype(np.float32),
         "K": np.tile(np.eye(3, dtype=np.float32), (rows, 1, 1)),
         "last_frame_poses": rng.normal(size=(rows, 3, 5)).astype(np.float32),
         "obj_bbox": np.zeros((rows, 4), np.float32), "scene_im_ids": ["a"]}
    if kps_type == "fps":
        b["obj_fps_points"] = rng.normal(size=(rows, NKPS, 3)).astype(np.float32)
        del b["obj_mean_points"]
    return b


@pytest.mark.parametrize("kps_type,cap", [("mean_shape", None), ("mean_shape", 12),
                                          ("bbox", 16), ("axis", 20), ("fps", 10)])
def test_batch_to_device_matches_jax(kps_type, cap, caplog):
    """Kept fields, the MAX_OBJS_TRAIN cap with its warning on dropped valid
    rows, and obj_kps of each keypoint type at the gt scale."""
    batch = _batch(16, 14, kps_type)
    kw = dict(max_objs=cap, kps_type=kps_type, num_kps=10 if kps_type == "axis" else NKPS,
              with_neg_axis=kps_type == "axis")
    with caplog.at_level(logging.WARNING):
        ref = jrunner._batch_to_device(dict(batch), **kw)
        n_ref = sum("dropped" in r.getMessage() for r in caplog.records)
        port = trunner.batch_to_device(dict(batch, pcl=torch.from_numpy(batch["pcl"])), "cpu",
                                       **kw)
    assert sum("dropped" in r.getMessage() for r in caplog.records) == 2 * n_ref
    assert n_ref == (1 if cap is not None and cap < 14 else 0)
    assert set(ref) == set(port) and "obj_bbox" not in port and "last_frame_poses" in port
    assert ("obj_kps" in port) == (kps_type != "fps")
    for k in ref:
        x, y = np.asarray(ref[k]), port[k].numpy()
        assert y.shape[0] == min(cap or 16, 16) and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    with pytest.raises(ValueError, match="obj_fps_points"):
        trunner.batch_to_device(_batch(4, 4), "cpu", kps_type="fps")


def test_get_train_dicts_matches_jax(split, monkeypatch):
    recs = [dict(r, annotations=[dict(a, visib_fract=v) for a, v in
                                 zip(r["annotations"], (0.05, 0.5, 0.9, 0.02))])
            for r in split] + [dict(split[0], annotations=[dict(split[0]["annotations"][0],
                                                                visib_fract=0.0)])]
    monkeypatch.setitem(jnocs._DATASET_REGISTRY, "train_a", lambda: recs[:3])
    monkeypatch.setitem(jnocs._DATASET_REGISTRY, "train_b", lambda: recs[3:])
    monkeypatch.setitem(tnocs._DATASET_REGISTRY, "train_a", lambda: recs[:3])
    monkeypatch.setitem(tnocs._DATASET_REGISTRY, "train_b", lambda: recs[3:])
    cfg = _set(load_config(str(FLAGSHIP_CONFIG)), {"DATALOADER.FILTER_VISIB_THR": 0.1})
    port = trunner.get_train_dicts(cfg, ["train_a", "train_b"])
    ref = jrunner._get_train_dicts(cfg, ["train_a", "train_b"])
    assert len(port) == len(ref) == len(split)          # the last image is left empty
    for a, b in zip(ref, port):
        assert a["scene_im_id"] == b["scene_im_id"] and a["annotations"] == b["annotations"]
    assert all(a["visib_fract"] > 0.1 for r in port for a in r["annotations"])


def test_shipped_train_loader_reads_the_shipped_config(split):
    loader = shipped_train_loader(split, device="cpu", mean_points=TABLE, num_pcl=NPCL,
                                  max_objs_per_image=M)
    assert (loader.phase, loader.ims_per_batch, loader.num_workers) == ("train", 64, 4)
    assert loader.cache_mode == "device" and loader.device_batches and loader._train_aug
    assert loader.cfg.sample_window == 64 and loader.cfg.sampler_train == "TrainingSampler"
    assert loader.seed == 0 and loader.cfg.num_pcl == NPCL
    batch = next(iter(loader))                 # 64 images of a 5-record split: 13 epochs
    assert batch["pcl"].shape == (64 * M, NPCL, 3) and torch.isfinite(batch["pcl"]).all()
    assert len(set(batch["scene_im_ids"])) == len(split)


def test_one_train_step_on_a_loader_batch(split, tmp_path):
    """train_from_split: the loader's batches through batch_to_device into
    the flagship train step, finite; under the last_frame init the batch
    carries the pickle's poses; the loader's draws make the steps repeat."""
    hist_steps = []
    state, hist = train_from_split(split, 2, device="cpu",
                                   callback=lambda i, m: hist_steps.append(i), **SMALL)
    assert state.step == 2 and hist_steps == [0, 1]
    assert all(torch.isfinite(v).all() for m in hist for v in m.values())
    assert all(torch.isfinite(p).all() for p in state.params.values())
    again = train_from_split(split, 1, device="cpu", **SMALL)[1]
    torch.testing.assert_close(again[0]["loss_total"], hist[0]["loss_total"], rtol=0, atol=0)

    rng = np.random.default_rng(0)
    prev = {}
    for r in split:
        n = len(r["annotations"])
        poses = np.stack([np.concatenate([a["pose"], a["scale"][:, None]], 1)
                          for a in r["annotations"]]).astype(np.float32)
        poses[:, :, 3] += rng.normal(0, 0.01, (n, 3))
        prev[r["scene_im_id"]] = poses
    path = tmp_path / "prev.pkl"
    path.write_bytes(pickle.dumps(prev))
    cfg = _set(load_config(str(FLAGSHIP_CONFIG)),
               {"INPUT.INIT_POSE_TYPE_TRAIN": ["last_frame"],
                "INPUT.INIT_SCALE_TYPE_TRAIN": ["last_frame"],
                "INPUT.INIT_POSE_TRAIN_PATH": str(path)})
    loader = shipped_train_loader(split, "cpu", cfg=cfg, **SMALL)
    assert loader._last_frame is not None
    batch = trunner.batch_to_device(next(iter(loader)), "cpu", max_objs=512)
    assert batch["last_frame_poses"].shape == (2 * M, 3, 5)
    state, hist = train_from_split(split, 1, device="cpu", cfg=cfg, **SMALL)
    assert all(torch.isfinite(v).all() for m in hist for v in m.values())


def test_train_from_split_runs_with_jax_blocked(tmp_path):
    """The train loader (device cache, device batches; and the aligned NOCS
    / RGB path) and a train step from it, with jax, flax, cv2 and PIL
    blocked."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'flax', 'cv2', 'PIL'):\n"
        "    sys.modules[blocked] = None\n"
        "import itertools, numpy as np, torch\n"
        "from catre_tpu_torch.entry import shipped_train_loader, train_from_split, "
        "write_example_split\n"
        "table = np.random.default_rng(0).normal(size=(6, 64, 3)).astype(np.float32)\n"
        f"recs = write_example_split({str(tmp_path)!r}, 4, 96, 128, m=4, images=True)\n"
        "kw = dict(mean_points=table, num_pcl=32, num_kps=64, max_objs_per_image=4,\n"
        "          ims_per_batch=2, num_workers=2)\n"
        "state, hist = train_from_split(recs, 1, device='cpu', **kw)\n"
        "assert state.step == 1 and all(torch.isfinite(v).all() for v in hist[0].values())\n"
        "ld = shipped_train_loader(recs, 'cpu', with_nocs=True, pcl_with_color=True,\n"
        "                          cache_decoded='', **kw)\n"
        "b = next(iter(ld))\n"
        "assert b['nocs'].shape == b['pcl_rgb'].shape == (8, 32, 3)\n"
        "assert not any(m == 'catre_tpu' or m.startswith('catre_tpu.') for m in sys.modules)\n"
        "assert not any(sys.modules.get(m) for m in ('jax', 'flax', 'cv2', 'PIL'))\n"
        "print('train loader ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train loader ok" in proc.stdout
