"""The port's training runner and CLI on their own (no JAX run):
`engine/runner.py::do_train`, `main.py` without --eval-only,
`utils/events.py`, `utils/profiler.py` and `utils/vis.py::draw_projected_kps`.

The split is `entry.write_example_split`'s (8 frames of 120 x 160 with colour
images, 4 slots) under `nocs_train_real` and `nocs_test_real`, and a second
split of 4 frames under `nocs_train2`; the mean-shape table is a seeded one
of 64 points (NUM_KPS 64). The config is the shipped `..._120e_tpu.py` in
f32 with NUM_PCL 64, IMS_PER_BATCH 4, TOTAL_EPOCHS 2 (4 iterations),
N_ITER_TRAIN 2 warmed over 2 epochs, CHECKPOINT_PERIOD 1 (iterations 1 and 3)
and PRINT_FREQ 1, with the shipped noise and augmentation.

One CLI training run (`main.main` without --eval-only, TEST.EVAL_PERIOD 2,
TRAIN.PROFILE_ITERS 1, TRAIN.VIS_IMG) serves several cases: its files, its
periodic evaluation kept in one context, --eval-only scoring its last
checkpoint, the trace and the three tensorboard images (their dots where
`cv2.circle(img, (u, v), 0, color, 2)` paints). A run resumed from its
checkpoint of iteration 1 ends bit-equal to it (model, optimizer state,
metrics from iteration 2), and so does one with TRAIN2 (both loaders
skipped); the TRAIN2 coin follows its formula and picks the batches' split; a
non-finite loss raises FloatingPointError naming its iteration; the event
storage and writers (after `tests/test_checkpoint_events.py`); the refusals.
"""

import copy
import json
import logging
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from catre_tpu_torch import main as tmain
from catre_tpu_torch.config.build import FLAGSHIP_CONFIG
from catre_tpu_torch.config.loader import apply_overrides, load_config
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import loader as tl
from catre_tpu_torch.data import nocs as tnocs
from catre_tpu_torch.data.png import decode_png
from catre_tpu_torch.engine import runner
from catre_tpu_torch.entry import write_example_split
from catre_tpu_torch.utils import checkpoint as tckpt
from catre_tpu_torch.utils import profiler
from catre_tpu_torch.utils.events import EventStorage, JSONWriter, MetricPrinter, TensorboardWriter
from catre_tpu_torch.utils.vis import draw_projected_kps, project

M, NPCL, NKPS, H, W = 4, 64, 64, 120, 160
TABLE = np.random.default_rng(11).normal(size=(6, NKPS, 3)).astype(np.float32) * 0.1
TRAIN2_SEED = 3          # its coins at iterations 0-3: True, False, False, False


@pytest.fixture(scope="module", autouse=True)
def splits(tmp_path_factory):
    """Both splits registered, the table patched, for the whole module."""
    root = tmp_path_factory.mktemp("splits")
    (root / "a").mkdir()
    (root / "b").mkdir()
    train = write_example_split(str(root / "a"), 8, h=H, w=W, m=M, seed=7, images=True)
    train2 = [dict(r, scene_im_id="second/" + r["scene_im_id"])
              for r in write_example_split(str(root / "b"), 4, h=H, w=W, m=M, seed=9)]
    mp = pytest.MonkeyPatch()
    for name, recs in (("nocs_train_real", train), ("nocs_test_real", train),
                       ("nocs_train2", train2)):
        mp.setitem(tnocs._DATASET_REGISTRY, name, lambda recs=recs: copy.deepcopy(recs))
    mp.setattr(tassets, "mean_shape_array", lambda *a, **k: TABLE)
    yield train, train2
    mp.undo()


def _close_cli_log():
    for h in tmain._HANDLERS:            # the log file of a CLI run
        logging.getLogger().removeHandler(h)
        h.close()
    tmain._HANDLERS.clear()


@pytest.fixture(autouse=True)
def _fresh():
    tl.clear_decoded_caches()
    yield
    tl.clear_decoded_caches()
    _close_cli_log()


def _opts(out_dir, *extra):
    return [f"OUTPUT_DIR={out_dir}", "SEED=0", f"INPUT.NUM_PCL={NPCL}", f"INPUT.NUM_KPS={NKPS}",
            "MODEL.BF16=False", "SOLVER.IMS_PER_BATCH=4", "SOLVER.TOTAL_EPOCHS=2",
            "MODEL.CATRE.N_ITER_TRAIN=2", "MODEL.CATRE.N_ITER_TRAIN_WARM_EPOCH=2",
            "SOLVER.WARMUP_ITERS=1", "SOLVER.CHECKPOINT_PERIOD=1", "TRAIN.PRINT_FREQ=1",
            "DATALOADER.NUM_WORKERS=0", f"DATALOADER.MAX_OBJS_PER_IMAGE={M}",
            "MODEL.LOAD_POSES_TEST=False", "TEST.IMS_PER_BATCH=4", "MODEL.CATRE.N_ITER_TEST=1",
            *extra]


def _cfg(out_dir, *extra):
    return apply_overrides(load_config(str(FLAGSHIP_CONFIG)), _opts(out_dir, *extra))


def _train(out_dir, *extra, resume=False):
    """main.main without --eval-only on the CPU -> its TrainState."""
    try:
        return tmain.main(["--config-file", str(FLAGSHIP_CONFIG), "--device", "cpu",
                           *(["--resume"] if resume else []), *_opts(out_dir, *extra)])
    finally:
        _close_cli_log()


def _spy_sources(mp, sources):
    """Record each iteration's split (the scene ids' first part)."""
    to_device = runner.batch_to_device

    def spy(batch, *a, **k):
        sources.append({s.split("/")[0] for s in batch["scene_im_ids"] if s})
        return to_device(batch, *a, **k)

    mp.setattr(runner, "batch_to_device", spy)


CLI_RUN = ("TEST.EVAL_PERIOD=2", "TRAIN.PROFILE_ITERS=1", "TRAIN.VIS_IMG=True")


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The shared CLI run -> (its OUTPUT_DIR, its TrainState, what it did:
    the contexts of its evaluations, the refines and test loaders built, each
    iteration's split)."""
    out = tmp_path_factory.mktemp("straight")
    seen = {"ctx": [], "refine": 0, "test_loader": 0, "sources": []}
    do_test, make_refine_fn, loader = runner.do_test, runner.make_refine_fn, runner.CATRELoader

    def spy_test(cfg, params_override=None, ctx=None, device="cuda"):
        seen["ctx"].append(ctx)
        return do_test(cfg, params_override, ctx, device)

    def spy_refine(*a, **k):
        seen["refine"] += 1
        return make_refine_fn(*a, **k)

    def spy_loader(*a, **k):
        seen["test_loader"] += k.get("phase") == "test"
        return loader(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(runner, "do_test", spy_test)
    mp.setattr(runner, "make_refine_fn", spy_refine)
    mp.setattr(runner, "CATRELoader", spy_loader)
    _spy_sources(mp, seen["sources"])
    tl.clear_decoded_caches()
    try:
        state = _train(out, *CLI_RUN)
    finally:
        mp.undo()
        tl.clear_decoded_caches()
    return out, state, seen


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def _assert_same(a, b, where="state"):
    """Nested dicts / lists / tensors equal bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


# ---- resume

@pytest.mark.parametrize("train2", [False, True])
def test_resume_is_bit_equal_to_the_straight_run(train2, straight, tmp_path, monkeypatch):
    """The checkpoint of iteration 1 alone in a fresh OUTPUT_DIR, `main
    --resume`: iterations 2 and 3 give the straight run's model, optimizer
    state and metrics bit for bit. The straight run is the shared CLI run, or
    with TRAIN2 (ratio 0.5, SEED 3: iteration 0 reads the second split, 1-3
    the first) a run of its own; then both loaders are skipped, 4 images
    each, and each iteration reads the split the coin says."""
    sources = []
    if train2:
        extra = ("DATASETS.TRAIN2=('nocs_train2',)", "DATASETS.TRAIN2_RATIO=0.5",
                 f"SEED={TRAIN2_SEED}")
        _spy_sources(monkeypatch, sources)
        out, state = tmp_path / "a", runner.do_train(_cfg(tmp_path / "a", *extra), device="cpu")
        assert [runner.pick_train2(TRAIN2_SEED, i, 0.5) for i in range(4)] == \
            [True, False, False, False]
        assert sources == [{"second"}, {"example"}, {"example"}, {"example"}]
    else:
        extra, (out, state, seen) = (), straight
        sources = list(seen["sources"])
        assert sources == [{"example"}] * 4
        _spy_sources(monkeypatch, sources)
    (tmp_path / "b" / "ckpt").mkdir(parents=True)
    shutil.copy(out / "ckpt" / "step_00000001.pt", tmp_path / "b" / "ckpt")
    resumed = _train(tmp_path / "b", *extra, resume=True)

    assert state.step == resumed.step == 4
    assert sources[4:] == sources[2:4]              # the resumed run read iterations 2 and 3
    _assert_same({k: p.detach() for k, p in state.params.items()},
                 {k: p.detach() for k, p in resumed.params.items()}, "params")
    _assert_same(state.optimizer.state_dict(), resumed.optimizer.state_dict(), "optimizer")
    _assert_same(tckpt.load_checkpoint(str(out / "ckpt")),
                 tckpt.load_checkpoint(str(tmp_path / "b" / "ckpt")), "last checkpoint")
    ours, ref = _metrics(tmp_path / "b"), _metrics(out)[2:]
    assert [r["iteration"] for r in ours] == [2, 3]
    for a, b in zip(ours, ref):
        a.pop("time", None)
        b.pop("time")
        assert a == b


def test_train2_picks_follow_the_formula():
    """pick_train2: the coin np.random.default_rng(SeedSequence((seed, 5,
    iteration))).random() < ratio, of the iteration alone."""
    for seed in (0, TRAIN2_SEED, 17):
        for ratio in (0.25, 0.5, 0.9):
            got = [runner.pick_train2(seed, it, ratio) for it in range(64)]
            want = [np.random.default_rng(np.random.SeedSequence((seed, 5, it))).random() < ratio
                    for it in range(64)]
            assert got == want and any(got) and not all(got)
    assert not any(runner.pick_train2(0, it, 0.0) for it in range(64))


# ---- the finite-loss check

def test_non_finite_loss_raises_naming_its_iteration(tmp_path, monkeypatch):
    """One loss term made infinite in iteration 1's step (its gradients stay
    finite): the check reads the first bad iteration at the next metric
    read (PRINT_FREQ 4: iteration 3) and raises naming both."""
    from catre_tpu_torch.engine import train

    loss = train.catre_loss
    calls = []

    def poisoned(*a, **k):
        out = loss(*a, **k)
        if len(calls) == 1:          # iterations 0 and 1 run one inner iteration each
            out["loss_PM_R"] = out["loss_PM_R"] + float("inf")
        calls.append(1)
        return out

    monkeypatch.setattr(train, "catre_loss", poisoned)
    with pytest.raises(FloatingPointError,
                       match=r"first observed at iteration 1 \(detected at iteration 3\)"):
        runner.do_train(_cfg(tmp_path, "TRAIN.PRINT_FREQ=4"), device="cpu")
    assert len(calls) == 6 and not (tmp_path / "metrics.json").read_text()

    bad = torch.tensor(-1, dtype=torch.int32)
    for it, loss in enumerate([[1.0, 2.0], [1.0, float("inf")], [float("nan"), 0.0]]):
        bad = runner._update_bad_iter(bad, torch.tensor(loss), it)
        assert bad.dtype == torch.int32 and int(bad) == (-1 if it == 0 else 1)


# ---- profiling and the training vis

def test_profile_iters_writes_a_trace(straight):
    """Iteration 2 (after the two that are skipped) traced into
    OUTPUT_DIR/profile as a Chrome trace with the step's ranges."""
    profiled = straight[0]
    traces = os.listdir(profiled / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(profiled / "profile" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.forward", "train.backward", "train.optimizer"} <= names


def test_vis_img_queues_three_images(straight, splits):
    """input_image, image_with_gt_kps and image_with_est_kps in OUTPUT_DIR/tb
    at every metric write; the input is a colour image of the split read as
    RGB, and the two others differ from it by red dots only."""
    from tensorboard.backend.event_processing import event_accumulator

    ea = event_accumulator.EventAccumulator(str(straight[0] / "tb"))
    ea.Reload()
    tags = ("input_image", "image_with_gt_kps", "image_with_est_kps")
    assert set(tags) <= set(ea.Tags()["images"])
    assert all([e.step for e in ea.Images(t)] == [0, 1, 2, 3] for t in tags)
    colours = [decode_png(open(r["file_name"], "rb").read())[:, :, ::-1] for r in splits[0]]
    n_dots = 0
    for step in range(4):
        img, gt, est = (decode_png(ea.Images(t)[step].encoded_image_string)[:, :, 2::-1]
                        for t in tags)
        assert any(np.array_equal(img, c) for c in colours)
        for drawn in (gt, est):
            changed = (drawn != img).any(axis=2)
            assert (drawn[changed] == (255, 0, 0)).all()
            n_dots += int(changed.sum())
    assert n_dots > 0        # an object whose keypoints all project off its image draws none


def test_draw_projected_kps_matches_cv2_circle():
    """Dots where cv2.circle(img, (u, v), 0, color, 2) paints them, at the
    rounded projections, those near and over the border clipped."""
    rng = np.random.default_rng(0)
    K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]])
    for trial in range(5):
        kps = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        scale = rng.uniform(0.1, 0.4, 3).astype(np.float32)
        pose = np.concatenate([np.eye(3), [[0.05 * trial], [0.0], [0.6]]], 1).astype(np.float32)
        image = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        got = draw_projected_kps(image, kps, scale, pose, K, color=(255, 0, 0))
        want = image.copy()
        for u, v in np.round(project(kps * scale, K, pose)).astype(int):
            if 0 <= u < W and 0 <= v < H:
                cv2.circle(want, (int(u), int(v)), 0, (255, 0, 0), 2)
        assert np.array_equal(got, want) and not np.array_equal(got, image)
    assert np.array_equal(image, image.copy())          # drawn on a copy


# ---- events and profiler helpers

def test_event_storage_and_writers(tmp_path):
    storage = EventStorage()
    for it in range(5):
        storage.iter = it
        storage.put_scalars(loss_total=1.0 / (it + 1), lr=1e-4)
    assert storage.latest()["loss_total"][1] == 4
    assert 0 < storage.median("loss_total") <= 1.0
    path = str(tmp_path / "metrics.json")
    w = JSONWriter(path)
    w.write(storage)
    w.close()
    rec = json.loads(open(path).read().strip())
    assert rec["iteration"] == 4 and "loss_total" in rec
    MetricPrinter(max_iter=10).write(storage)  # must not raise
    seconds, out = profiler.timed(lambda x: x * 2, torch.ones(3), reps=3, warmup=1)
    assert seconds >= 0 and torch.equal(out, torch.full((3,), 2.0))
    profiler.sync()


def test_tb_histograms(tmp_path):
    """put_histogram flushes to tensorboard (`my_writer.py:102-105`)."""
    from tensorboard.backend.event_processing import event_accumulator

    storage = EventStorage(0)
    storage.put_histogram("grads/rot_head", np.random.default_rng(0).normal(size=256))
    w = TensorboardWriter(str(tmp_path / "tb"))
    w.write(storage)
    w.close()
    assert not storage._histograms  # drained
    ea = event_accumulator.EventAccumulator(str(tmp_path / "tb"))
    ea.Reload()
    assert "grads/rot_head" in ea.Tags().get("histograms", [])


# ---- the command line

def test_cli_trains_evaluates_and_scores(straight, tmp_path):
    """The shared run wrote log.txt, config_dump.py, metrics.json, tb/,
    profile/ and ckpt/step_*.pt; TEST.EVAL_PERIOD 2 evaluated at iterations 1
    and 3 in one context (one eval model, test loader and refine).
    --eval-only then scores the last checkpoint and predicts what the last
    periodic evaluation predicted."""
    out, state, seen = straight
    assert state.step == 4
    assert {"log.txt", "config_dump.py", "metrics.json", "tb", "profile", "ckpt",
            "predictions.pkl"} <= set(os.listdir(out))
    assert sorted(os.listdir(out / "ckpt")) == ["step_00000001.pt", "step_00000003.pt"]
    assert "training done: 4 iterations" in (out / "log.txt").read_text()
    assert [r["iteration"] for r in _metrics(out)] == [0, 1, 2, 3]
    assert len(seen["ctx"]) == 2 and seen["ctx"][0] is seen["ctx"][1]
    assert seen["refine"] == seen["test_loader"] == 1
    with open(out / "predictions.pkl", "rb") as f:
        periodic = pickle.load(f)

    scored = tmp_path / "scored"
    res = tmain.main(["--config-file", str(FLAGSHIP_CONFIG), "--eval-only", "--device", "cpu",
                      *_opts(scored, f"MODEL.WEIGHTS={out / 'ckpt'}")])["nocs_test_real"]
    assert sorted(res["results"]) == [0, 1]
    with open(scored / "predictions.pkl", "rb") as f:
        again = pickle.load(f)
    _assert_same(_bytes(periodic), _bytes(again), "predictions")


def _bytes(preds):
    return [{sid: {k: (v.dtype, v.tobytes()) for k, v in p.items()} for sid, p in it.items()}
            for it in preds]


def test_training_refusals(tmp_path):
    """NUM_CHIPS 2 names item 14; the default device needs a card."""
    with pytest.raises(NotImplementedError, match="item 14"):
        runner.do_train(_cfg(tmp_path, "NUM_CHIPS=2"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            runner.do_train(_cfg(tmp_path))
