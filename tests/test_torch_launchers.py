"""The port's launchers: `test_catre_torch.sh`, `train_catre_torch.sh` and
`scripts/repro_real275_torch.sh`, run on the CPU (`--device cpu`) in
subprocesses whose Python has jax, flax, cv2 and PIL blocked (a
`sitecustomize.py` on PYTHONPATH).

A REAL275-shaped data root is written once: the asset pickles, real_test
frames from `tools/synth_nocs`, SPD-style init poses (the gt poses with
noise, the gt masks) and a reference-layout `.pth` of the flagship model
(`tests/torch_mirror.py`, torch's seeded initialisation).

- The test launcher's predictions and tables equal those of `python -m
  catre_tpu_torch.main --eval-only` on the same root, config (the repro
  script's) and arguments, and a later MODEL.WEIGHTS override still wins over
  the launcher's.
- The train launcher trains 2 iterations of a written real_train split.
- The repro script checks the assets, converts the `.pth`, evaluates it with
  the init poses and ends in `repro_diff`'s exit 0 against a summary of that
  run's table, its predictions equal to that run's.
"""

import json
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from catre_tpu_torch.config.build import CONFIG_DIR, FLAGSHIP_CONFIG
from catre_tpu_torch.data import meta, nocs
from catre_tpu_torch.tools import synth_nocs
from catre_tpu_torch.tools.fetch_assets import CKPT_NAME

from torch_mirror import TorchCATRE

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
BLOCKED = ("jax", "flax", "cv2", "PIL")
TEST_FRAMES, TRAIN_FRAMES = 2, 4
RUN_TIMEOUT_S = 300
INIT_REL = osp.join("NOCS", "test_init_poses", "init_pose_spd_nocs_real.json")
EVAL_OPTS = ["TEST.IMS_PER_BATCH=2", "DATALOADER.NUM_WORKERS=0", "SEED=0"]
# the repro script's config (the reference's 120e config, f32 and unfused)
REPRO_CONFIG = str(CONFIG_DIR / "nocs_real" /
                   "aug05_kpsMS_r9d_catreDisR_shared_tspcl_convPerRot_scaleexp_120e.py")


def _env(data_root, tmp):
    """No JAX / XLA / CATRE_ variables but the data root; the blocked
    modules; this interpreter first on PATH (the scripts call `python`)."""
    block = osp.join(tmp, "block")
    os.makedirs(block, exist_ok=True)
    with open(osp.join(block, "sitecustomize.py"), "w") as f:
        f.write("import sys\n"
                f"for _m in {BLOCKED!r}:\n"
                "    sys.modules[_m] = None\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "CATRE_"))}
    env.update(CATRE_DATA_ROOT=data_root, PYTHONPATH=block, OMP_NUM_THREADS="2",
               PATH=osp.dirname(sys.executable) + os.pathsep + env.get("PATH", ""))
    return env


def _run(cmd, env):
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-6000:])
    return proc


def write_real275_root(data: str, n_test: int, n_train: int = 0, seed: int = 0) -> dict:
    """A REAL275-shaped data root under `data`: the asset pickles, real_test
    (and real_train) frames from synth_nocs, SPD-style init poses and a
    reference-layout .pth; -> the records of nocs_test_real."""
    old = meta.DATA_ROOT
    try:
        meta.set_data_root(data)
        os.makedirs(meta.MODEL_DIR)
        rng = np.random.default_rng(seed)
        assets = {meta.CR_MEAN_MODEL_PATH: {o: rng.normal(size=(1024, 3)).astype(np.float32)
                                            * 0.15 for o in meta.OBJECTS},
                  meta.ABS_SCALE_PATH: {f"{o}_{i}_norm": rng.uniform(0.08, 0.3, 3)
                                        .astype(np.float32) for o in meta.OBJECTS
                                        for i in range(2)}}
        for path, obj in assets.items():
            with open(path, "wb") as f:
                pickle.dump(obj, f)
        real = osp.join(data, "NOCS", "REAL")
        synth_nocs.generate_split(real, split="real_test", n_frames=n_test, n_objs=3, seed=seed)
        if n_train:
            synth_nocs.generate_split(real, split="real_train", n_frames=n_train, n_objs=3,
                                      seed=seed + 1)
        records = nocs.NOCSDataset("nocs_test_real", use_cache=False)()
        init = {}
        for r in records:
            init[r["scene_im_id"]] = [
                {"obj_id": a["category_id"] + 1, "score": 0.9,
                 "pose_est": (np.asarray(a["pose"]) + rng.normal(0, 0.01, (3, 4))).tolist(),
                 "scale_est": (np.asarray(a["scale"]) * 1.05).tolist(),
                 "bbox_est": list(map(float, a["bbox"])), "segmentation": a["segmentation"]}
                for a in r["annotations"]]
        os.makedirs(osp.dirname(osp.join(data, INIT_REL)))
        with open(osp.join(data, INIT_REL), "w") as f:
            json.dump(init, f)
        os.makedirs(osp.join(data, "checkpoints"))
        torch.manual_seed(seed)
        torch.save(TorchCATRE().state_dict(), osp.join(data, "checkpoints", CKPT_NAME))
    finally:
        meta.set_data_root(old)
    return records


@pytest.fixture(scope="module")
def real_root(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("launchers"))
    data = osp.join(tmp, "data")
    records = write_real275_root(data, TEST_FRAMES, TRAIN_FRAMES)
    # the reference: python -m catre_tpu_torch.main --eval-only, same root and arguments
    out = osp.join(tmp, "main")
    _run([sys.executable, "-m", "catre_tpu_torch.main", "--config-file", REPRO_CONFIG,
          "--eval-only", "--device", "cpu",
          f"MODEL.WEIGHTS={osp.join(data, 'checkpoints', CKPT_NAME)}", f"OUTPUT_DIR={out}",
          *EVAL_OPTS, f"DATASETS.INIT_POSE_FILES_TEST=('{osp.join(data, INIT_REL)}',)"],
         _env(data, tmp))
    return {"tmp": tmp, "data": data, "records": records, "ref_out": out}


def _predictions(out):
    with open(osp.join(out, "predictions.pkl"), "rb") as f:
        return pickle.load(f)


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_test_launcher_equals_main_eval_only(real_root):
    data, tmp = real_root["data"], real_root["tmp"]
    env = _env(data, tmp)
    out = osp.join(tmp, "launcher")
    ckpt = osp.join(data, "checkpoints", CKPT_NAME)
    init = f"DATASETS.INIT_POSE_FILES_TEST=('{osp.join(data, INIT_REL)}',)"
    _run(["./test_catre_torch.sh", REPRO_CONFIG, "1", ckpt, "--device", "cpu",
          f"OUTPUT_DIR={out}", *EVAL_OPTS, init], env)
    ref, got = _predictions(real_root["ref_out"]), _predictions(out)
    assert sorted(got[0]) == sorted(r["scene_im_id"] for r in real_root["records"])
    assert _same(ref, got)
    for i in range(5):
        name = f"metrics_tab_iter{i}.txt"
        assert open(osp.join(out, name)).read() == open(osp.join(real_root["ref_out"], name)).read()
    # a later MODEL.WEIGHTS override replaces the launcher's
    proc = subprocess.run(["./test_catre_torch.sh", REPRO_CONFIG, "1", ckpt, "--device",
                           "cpu", f"OUTPUT_DIR={osp.join(tmp, 'other')}",
                           f"MODEL.WEIGHTS={osp.join(tmp, 'absent.pth')}", *EVAL_OPTS],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    assert proc.returncode != 0 and "absent.pth" in proc.stderr


def test_train_launcher_trains_two_iterations(real_root):
    data, tmp = real_root["data"], real_root["tmp"]
    out = osp.join(tmp, "train")
    _run(["./train_catre_torch.sh", str(FLAGSHIP_CONFIG), "1", "--device", "cpu",
          f"OUTPUT_DIR={out}", "SEED=0", "INPUT.NUM_PCL=32",
          f"SOLVER.IMS_PER_BATCH={TRAIN_FRAMES // 2}", "SOLVER.TOTAL_EPOCHS=1",
          "MODEL.CATRE.N_ITER_TRAIN=1", "SOLVER.WARMUP_ITERS=1", "TRAIN.PRINT_FREQ=1",
          "SOLVER.CHECKPOINT_PERIOD=1", "TEST.EVAL_PERIOD=0", "DATALOADER.NUM_WORKERS=0",
          "DATALOADER.MAX_OBJS_PER_IMAGE=4"], _env(data, tmp))
    log = open(osp.join(out, "log.txt")).read()
    assert "training done: 2 iterations" in log
    lines = [json.loads(x) for x in open(osp.join(out, "metrics.json"))]
    assert [x["iteration"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["loss_total"]) for x in lines)


def test_repro_script_ends_in_repro_diff(real_root):
    data, tmp = real_root["data"], real_root["tmp"]
    out = osp.join(tmp, "repro")
    with open(osp.join(real_root["ref_out"], "metrics_tab_iter4.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    summary = {r[0]: float(r[-1]) for r in rows[1:] if r[0] in ("IoU50", "IoU75", "re5te2")}
    assert len(summary) == 3, rows[0]
    ref_json = osp.join(tmp, "ref_summary.json")
    with open(ref_json, "w") as f:
        json.dump(summary, f)
    env = dict(_env(data, tmp), CATRE_REF_SUMMARY_JSON=ref_json)
    proc = _run(["scripts/repro_real275_torch.sh", data, out, "--device", "cpu", *EVAL_OPTS],
                env)
    assert "all assets present" in proc.stdout and "parity OK" in proc.stdout
    assert osp.isdir(osp.join(out, "converted_ckpt"))
    assert _same(_predictions(real_root["ref_out"]), _predictions(out))
    shutil.rmtree(out)
