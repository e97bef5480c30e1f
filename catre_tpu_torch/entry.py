"""Entry points: the flagship 4-iteration refine and the flagship training
step, built from the shipped production config.

Counterpart of `__graft_entry__.py` (`entry` :83, `_flagship` :6,
`_example_batch` :21, `_near_identity_params` :44). The model configuration
comes from `catre_tpu/configs/nocs_real/..._120e_tpu.py` (bf16, fused rot
head, fused encoder tails, FUSED_HEADS_TRAIN, FUSED_ENCODER_TRAIN) read
through the port's own loader; the weights are random, from a seed.
`example_frames` makes depth frames for the sampler (`data.loader`), whose
clouds the refine takes in place of `example_batch`'s; `write_example_split`
writes such frames to disk as a split (the counterpart of
`bench.py::_write_synthetic_frames`), `shipped_test_loader` reads a split
through the shipped config's test loader, and `evaluate_split` refines and
scores it with the fixed-IoU NOCS protocol; `shipped_train_loader` reads it
through the shipped config's train loader, and `train_from_split` trains the
flagship step on its batches.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config.build import (FLAGSHIP_CONFIG, loader_config_from, loss_config_from,
                           model_config_from, noise_config_from)
from .config.loader import load_config
from .data import png
from .data.loader import CATRELoader, LoaderConfig, mask_bbox_rows, pack_masks
from .data.rle import binary_mask_to_rle
from .engine.refiner import make_refine_fn
from .engine.runner import batch_to_device
from .engine.train import TrainState, TrainStep, init_train_state, make_train_step
from .eval.evaluator import CATREEvaluator, pack_host, run_inference, unpack_refine_args
from .geom.rotations import euler_to_mat
from .geom.symmetry import axis_symmetry_rotation_bank
from .models.catre import CATREConfig, CATREDisRShared, init_model
from .ops.limits import check_model_limits
from .solver.build import optimizer_from_config
from .utils.profiler import span

N_ITER = 4
# NOCS-REAL intrinsics of a 640 x 480 frame
REAL_K = ((591.0125, 0.0, 322.525), (0.0, 590.16775, 244.11084), (0.0, 0.0, 1.0))


def flagship_config(**overrides) -> CATREConfig:
    """`CATREConfig` of the shipped production config, with field overrides
    (`fused_encoder`, which no config key sets, among them), held to the
    kernels' shape limits."""
    cfg = dataclasses.replace(model_config_from(load_config(str(FLAGSHIP_CONFIG))), **overrides)
    check_model_limits(cfg)
    return cfg


def example_batch(b: int, num_pcl: int, num_kps: int, device="cpu", seed: int = 0) -> dict:
    """Synthetic refine inputs (made with numpy from `seed`): identity init
    rotation at 1 m, clouds around it, NOCS-REAL intrinsics."""
    rng = np.random.default_rng(seed)
    R = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    t = np.tile(np.array([0.0, 0.0, 1.0], dtype=np.float32), (b, 1))
    K = np.tile(np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]],
                         np.float32), (b, 1, 1))
    arrays = {
        "pcl": rng.normal(size=(b, num_pcl, 3)).astype(np.float32) * 0.1 + t[:, None, :],
        "obj_kps": rng.normal(size=(b, num_kps, 3)).astype(np.float32) * 0.3,
        "obj_pose": np.concatenate([R, t[:, :, None]], axis=2),
        "obj_scale": rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32),
        "obj_mean_scales": rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32),
        "K": K,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def example_frames(g: int, h: int = 480, w: int = 640, m: int = 8, seed: int = 0,
                   objs=(2, 8), size_px=(40, 200), hole_share: float = 0.05) -> dict:
    """Synthetic depth frames for the sampler (numpy, from `seed`): per image
    a tilted background at 1.2-1.6 m, `objs` ellipsoidal depth bumps of
    `size_px` axes at 0.6-1.1 m (nearer ones occlude), `hole_share` of the
    pixels at zero depth, NOCS-REAL intrinsics scaled to the frame. Each real
    instance has its mask, its bbox and an init pose near its backprojected
    centre; the other slots of `m` are padded as the loader pads them (empty
    mask, bbox (H, -1, W, -1), identity pose at 1 m, scale 0.1).

    Returns depth (G, H, W) uint16 millimetres, masks (G, m, H, W) bool,
    packed (G, H, W) words (`pack_masks`), mask_bbox (G, m, 4) int32, K (G, 3,
    3), poses (G, m, 3, 4), scales (G, m, 3), n_objs (G,), and `records`,
    dataset dicts with each instance's `bbox_est` (x1, y1, x2, y2)."""
    rng = np.random.default_rng(seed)
    K = np.array(REAL_K, np.float32)
    K[0] *= w / 640.0
    K[1, 1:] *= h / 480.0
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rows, cols = np.mgrid[0:h, 0:w]
    out = {"depth": np.zeros((g, h, w), np.uint16), "masks": np.zeros((g, m, h, w), bool),
           "poses": np.tile(np.eye(3, 4, dtype=np.float32), (g, m, 1, 1)),
           "scales": np.full((g, m, 3), 0.1, np.float32), "n_objs": np.zeros(g, np.int64),
           "K": np.tile(K, (g, 1, 1)), "records": []}
    out["poses"][..., 2, 3] = 1.0
    for i in range(g):
        z = rng.uniform(1.2, 1.6) + rng.uniform(-0.1, 0.1) * (rows / h - 0.5) \
            + rng.uniform(-0.1, 0.1) * (cols / w - 0.5)
        owner = np.full((h, w), -1)
        n = int(rng.integers(objs[0], objs[1] + 1))
        annos = []
        for j in range(n):
            ay, ax = rng.uniform(*size_px, size=2) / 2.0
            oy, ox = rng.uniform(0, h), rng.uniform(0, w)
            zc = rng.uniform(0.6, 1.1)
            q = ((rows - oy) / ay) ** 2 + ((cols - ox) / ax) ** 2
            bump = zc - ax * zc / fx * np.sqrt(np.clip(1.0 - q, 0.0, 1.0))
            front = (q < 1.0) & (bump < z)
            z = np.where(front, bump, z)
            owner[front] = j
            t = np.array([(ox - cx) / fx * zc, (oy - cy) / fy * zc, zc]) + rng.normal(0, 0.01, 3)
            ex = np.array([2 * ax * zc / fx, 2 * ay * zc / fy, 2 * ax * zc / fx])
            a, b, c = rng.uniform(-np.pi, np.pi, 3)
            R = euler_to_mat(torch.tensor([a, b, c], dtype=torch.float32)).numpy()
            out["poses"][i, j] = np.concatenate([R, t[:, None]], axis=1)
            out["scales"][i, j] = ex * rng.uniform(0.9, 1.1, 3)
            annos.append({"bbox_est": [max(ox - ax, 0.0), max(oy - ay, 0.0),
                                       min(ox + ax, w - 1.0), min(oy + ay, h - 1.0)]})
        depth = np.round(z * 1000.0)
        depth[rng.random((h, w)) < hole_share] = 0
        out["depth"][i] = depth.astype(np.uint16)
        out["masks"][i, :n] = owner[None] == np.arange(n)[:, None, None]
        out["n_objs"][i] = n
        out["records"].append({"annotations": annos})
    out["packed"] = np.stack([pack_masks(mk) for mk in out["masks"]])
    out["mask_bbox"] = np.stack([mask_bbox_rows(mk) for mk in out["masks"]])
    return out


def _write_example_frame(root: str, f: int, h: int, w: int, m: int, seed: int,
                         images: bool) -> dict:
    """Frame f of `write_example_split`, from its own seed."""
    frame_seed = int(np.random.SeedSequence((seed, f)).generate_state(1)[0])
    fr = example_frames(1, h, w, m=m, seed=frame_seed, objs=(min(2, m), m),
                        size_px=(40 * h / 480, 200 * h / 480))
    path = os.path.join(root, f"{f:04d}_depth.png")
    png.write_png(path, fr["depth"][0], level=1)
    annos = []
    for j, anno in enumerate(fr["records"][0]["annotations"]):
        pose, scale = fr["poses"][0, j], fr["scales"][0, j]
        annos.append({"category_id": j % 6, "pose": pose, "scale": scale,
                      "pose_est": pose.copy(), "scale_est": scale.copy(),
                      "bbox": list(anno["bbox_est"]), "bbox_est": list(anno["bbox_est"]),
                      "segmentation": binary_mask_to_rle(fr["masks"][0, j]),
                      "score": 1.0, "mug_handle": 1})
    rec = {"scene_im_id": f"example/{f:04d}", "depth_file": path, "height": h, "width": w,
           "cam": fr["K"][0], "annotations": annos, "gt_annotations": annos}
    if images:
        rng = np.random.default_rng(frame_seed)
        # colour: a random 8-bit image; coordinates: each instance's pixels
        # by their column (R) and row (G) in its mask's bounds and one random
        # B of its own, the background 255
        bgr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        coord = np.full((h, w, 3), 255, np.uint8)
        rows, cols = np.mgrid[0:h, 0:w]
        for j in range(len(annos)):
            mask = fr["masks"][0, j]
            if not mask.any():
                continue
            r, c = rows[mask], cols[mask]
            coord[mask, 2] = (255 * (c - c.min()) / max(1, c.max() - c.min())).astype(np.uint8)
            coord[mask, 1] = (255 * (r - r.min()) / max(1, r.max() - r.min())).astype(np.uint8)
            coord[mask, 0] = rng.integers(0, 256, dtype=np.uint8)
        rec["file_name"] = os.path.join(root, f"{f:04d}_color.png")
        rec["coord_file"] = os.path.join(root, f"{f:04d}_coord.png")
        png.write_png(rec["file_name"], bgr, level=1)
        png.write_png(rec["coord_file"], coord, level=1)
    return rec


def write_example_split(root: str, n_frames: int, h: int = 480, w: int = 640, m: int = 8,
                        seed: int = 0, images: bool = False) -> list:
    """Write `n_frames` of `example_frames` under `root` as a split: 16-bit
    depth PNGs through `data.png`, each instance's mask as an RLE
    `segmentation`, its pose, scale, init estimate (the same), bbox, score
    and a category (slot % 6), as `bench.py::_write_synthetic_frames` writes
    its records. With `images`, also an 8-bit colour PNG (`file_name`) and a
    NOCS-style coordinate PNG (`coord_file`), both written from BGR arrays as
    OpenCV writes them. Frames hold 2 to m objects of 40-200 px at 480 rows,
    scaled with h. Frame f depends on (seed, f) only, so a shorter split is a
    prefix of a longer one. Returns the records."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda f: _write_example_frame(root, f, h, w, m, seed, images),
                             range(n_frames)))


def shipped_test_loader(records: list, device="cuda", **kw) -> CATRELoader:
    """The shipped config's test loader over `records`, as a single-process
    `do_test` builds it: TEST.IMS_PER_BATCH, DATALOADER.NUM_WORKERS and
    CACHE_DECODED, the auto window, device batches. Keywords that name a
    `LoaderConfig` field replace it; the rest go to `CATRELoader`
    (`mean_points`, `draws`, `ims_per_batch`, ...)."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    fields = {f.name for f in dataclasses.fields(LoaderConfig)}
    lcfg = dataclasses.replace(loader_config_from(cfg, "test"),
                               **{k: kw.pop(k) for k in list(kw) if k in fields})
    args = {"ims_per_batch": int(cfg.TEST.IMS_PER_BATCH),
            "num_workers": int(cfg.DATALOADER.get("NUM_WORKERS", 0)), "device_batches": True}
    args.update(kw)
    return CATRELoader(records, lcfg, phase="test", device=device, **args)


def shipped_train_loader(records: list, device="cuda", **kw) -> CATRELoader:
    """The shipped config's train loader over `records`, as a single-process
    JAX `do_train` builds it (`catre_tpu/engine/runner.py:235-248`):
    SOLVER.IMS_PER_BATCH images a group (64: B = 512 slots), SEED (at least
    0), DATALOADER.NUM_WORKERS and CACHE_DECODED, the auto window, AUG_DEPTH,
    device batches. Keywords that name a `LoaderConfig` field replace it; the
    rest go to `CATRELoader` (`mean_points`, `draws`, `aug_draws`, `seed`,
    ...). `cfg=` reads another config tree."""
    cfg = kw.pop("cfg", None) or load_config(str(FLAGSHIP_CONFIG))
    fields = {f.name for f in dataclasses.fields(LoaderConfig)}
    lcfg = dataclasses.replace(loader_config_from(cfg, "train"),
                               **{k: kw.pop(k) for k in list(kw) if k in fields})
    args = {"ims_per_batch": int(cfg.SOLVER.IMS_PER_BATCH), "seed": max(int(cfg.get("SEED", 0)), 0),
            "num_workers": int(cfg.DATALOADER.get("NUM_WORKERS", 0)),
            "device_batches": not (lcfg.with_nocs or lcfg.pcl_with_color)}
    args.update(kw)
    return CATRELoader(records, lcfg, phase="train", device=device, **args)


def loader_refine_args(batch: dict, mean_table: torch.Tensor) -> tuple:
    """A test loader batch -> the refine's arguments on the table's device:
    the clouds, the mean-shape keypoints gathered there by class from the
    (6, K, 3) table, the init estimate, K and the mean scales. The host
    fields travel as one (B, 28) row an object (`eval.evaluator.pack_host`),
    as `run_inference` sends them."""
    dev = mean_table.device
    packed = pack_host(batch, pin=dev.type == "cuda").to(dev, non_blocking=True)
    return unpack_refine_args(torch.as_tensor(batch["pcl"]).to(dev), mean_table, packed)


def evaluate_split(records: list, device="cuda", mean_table=None, seed: int = 0,
                   n_iters: int = N_ITER, *, output_dir: str | None = None, warmup: int = 1,
                   compute_probe_every: int = 8, **loader_kw) -> tuple:
    """Score a split: the shipped test loader over `records`
    (`shipped_test_loader`; `loader_kw` go to it), the shipped refine of
    `n_iters` iterations with seeded weights on `device` (its point counts
    follow the loader's), a `CATREEvaluator` over `records`, then
    `eval.run_inference` (packed inputs, prefetch 2) and `evaluate()`. The
    inner loop of JAX `do_test` (`catre_tpu/engine/runner.py:480-600`) for one
    dataset; `engine.runner.do_test` is the whole of it, from a config, and
    gives the same predictions on the same records, weights and table.
    `mean_table` is the (6, K, 3) mean-shape
    table (None: the asset file), gathered on the device by class, so the
    loader ships no per-object mean points unless `ship_mean_points=True`.
    -> (stats, results): `run_inference`'s statistics plus `score_s`, the
    seconds of `evaluate()`, and its per-iteration tables."""
    if mean_table is not None:
        loader_kw.setdefault("mean_points", np.asarray(mean_table, np.float32))
    loader_kw.setdefault("ship_mean_points", False)
    loader = shipped_test_loader(records, device, **loader_kw)
    cfg = flagship_config(num_pcl=loader.cfg.num_pcl, num_kps=loader.cfg.num_kps)
    refine = make_refine_fn(init_model(cfg, seed=seed, device=device), n_iter=n_iters)
    evaluator = CATREEvaluator(records, n_iters=n_iters, output_dir=output_dir)
    stats = run_inference(refine, loader, evaluator, n_iters, warmup=warmup,
                          kps_type=loader.cfg.kps_type, num_kps=loader.cfg.num_kps,
                          compute_probe_every=compute_probe_every, mean_table=mean_table)
    t0 = time.perf_counter()
    results = evaluator.evaluate()
    return dict(stats, score_s=time.perf_counter() - t0), results


def near_identity_model(model: CATREDisRShared) -> CATREDisRShared:
    """Copy of `model` whose head output layers are canned so that every
    refine iteration predicts the exact identity delta for the shipped
    composition (image-space cosypose translation, iter_add scale, ego
    rot6d): rot6d = (1,0,0),(0,1,0); trans = (0,0,1); scale delta = 0.
    With init == gt the refined poses and scales must equal the init."""
    m = copy.deepcopy(model)
    with torch.no_grad():
        for head, bias in ((m.rot_head.rot_head_x, (1.0, 0.0, 0.0)),
                           (m.rot_head.rot_head_y, (0.0, 1.0, 0.0))):
            head.neck.weight.zero_()
            head.neck.bias.copy_(torch.tensor(bias))
            head.point_bias.zero_()
            head.point_weight.zero_()
            head.point_weight[0] = 1.0   # the neck bias passes through once
        m.ts_head.fc_t.weight.zero_()
        m.ts_head.fc_t.bias.copy_(torch.tensor([0.0, 0.0, 1.0]))
        m.ts_head.fc_s.weight.zero_()
        m.ts_head.fc_s.bias.zero_()
    return m


def entry(device="cuda", batch_size: int = 8, seed: int = 0, **overrides):
    """(fn, example_args): the flagship 4-iteration refine (1024 observed
    points + 1024 prior keypoints) on `device`; fn(*example_args) returns
    (poses (5, B, 3, 4), scales (5, B, 3)). `overrides` replace fields of
    the model's `CATREConfig`: `fused_encoder=True` runs the encoder columns
    through K9, `fused_block_size=4` the rot head through K8."""
    cfg = flagship_config(**overrides)
    model = init_model(cfg, seed=seed, device=device)
    refine = make_refine_fn(model, n_iter=N_ITER)
    b = example_batch(batch_size, cfg.num_pcl, cfg.num_kps, device=device, seed=seed)
    args = (b["pcl"], b["obj_kps"], b["obj_pose"], b["obj_scale"], b["K"], b["obj_mean_scales"])
    return refine, args


def train_batch(b: int, num_pcl: int, num_kps: int, device="cpu", seed: int = 0) -> dict:
    """Synthetic training batch (numpy, from `seed`), as
    `tests/test_engine.py::_synthetic_batch`: an anisotropically scaled
    canonical shape (the keypoints) posed in the camera frame (the cloud),
    every third object y-symmetric, all rows valid."""
    rng = np.random.default_rng(seed)
    canonical = rng.normal(size=(b, max(num_pcl, num_kps), 3)).astype(np.float32)
    canonical /= np.abs(canonical).max(axis=(1, 2), keepdims=True) * 2
    scale = rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32)
    euler = rng.uniform(-np.pi, np.pi, size=(b, 3)).astype(np.float32)
    R = euler_to_mat(torch.from_numpy(euler)).numpy()
    t = np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                  rng.uniform(0.6, 1.2, b)], axis=1).astype(np.float32)
    pcl = np.einsum("bij,bpj->bpi", R, canonical[:, :num_pcl] * scale[:, None, :]) + t[:, None]
    K = np.tile(np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]], np.float32),
                (b, 1, 1))
    arrays = {
        "pcl": pcl.astype(np.float32), "obj_kps": canonical[:, :num_kps],
        "obj_pose": np.concatenate([R, t[:, :, None]], axis=2).astype(np.float32),
        "obj_scale": scale, "obj_mean_scales": scale, "K": K,
        "sym_flag": np.arange(b) % 3 == 0, "valid": np.ones(b, dtype=bool),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


@dataclasses.dataclass
class Trainer:
    """Everything one flagship training step needs."""

    step: TrainStep
    state: TrainState
    batch: dict
    generator: torch.Generator
    lr: float


def solver_example_config():
    """The shipped config with clipping by the global norm, the rot head at
    half the lr (LR_MULT 0.5), the TS head frozen and three init modes drawn
    per step: the solver path that the shipped config bypasses
    (`chip_smoke.py` phase 7b, `tools/profile_train.py --solver-config`)."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    cfg.SOLVER.CLIP_GRADIENTS.update(ENABLED=True, CLIP_TYPE="norm")
    cfg.MODEL.CATRE.ROT_HEAD.LR_MULT = 0.5
    cfg.MODEL.CATRE.TS_HEAD.FREEZE = True
    cfg.INPUT.INIT_POSE_TYPE_TRAIN = ["gt_noise", "random", "canonical"]
    return cfg


def flagship_trainer(device="cuda", batch_size: int = 512, seed: int = 0, cfg=None,
                     **model_overrides) -> Trainer:
    """The shipped config's training set-up (rot head K3/K4, encoder tails
    K5/K6): a seeded model on `device`, the optimizer of `cfg`'s SOLVER and
    heads' LR_MULT / FREEZE (`solver.build.optimizer_from_config`) at its base
    lr, the train step at N_ITER_TRAIN inner iterations with `cfg`'s INPUT
    noise and init modes, and a synthetic batch. `cfg` defaults to the shipped
    config as read from its file. `model_overrides` replace fields of the
    model's `CATREConfig`, e.g. `fused_encoder_train=False` for the plain
    encoder under autograd."""
    cfg = load_config(str(FLAGSHIP_CONFIG)) if cfg is None else cfg
    mcfg = dataclasses.replace(model_config_from(cfg), **model_overrides)
    model = init_model(mcfg, seed=seed, device=device)
    optimizer = optimizer_from_config(cfg, model)
    sym_bank = axis_symmetry_rotation_bank(
        max_sym_disc_step=float(cfg.INPUT.get("MAX_SYM_DISC_STEP", 0.01)))
    step = make_train_step(model, loss_config_from(cfg), noise_config_from(cfg), optimizer,
                           sym_bank, n_iter=int(cfg.MODEL.CATRE.N_ITER_TRAIN))
    return Trainer(step, init_train_state(model, optimizer),
                   train_batch(batch_size, mcfg.num_pcl, mcfg.num_kps, device=device, seed=seed),
                   torch.Generator().manual_seed(seed), optimizer.param_groups[0]["lr"])


def train_entry(device="cuda", batch_size: int = 512, steps: int = 3, seed: int = 0,
                callback=None, cfg=None, lr_fn=None, batches=None, **model_overrides):
    """`steps` flagship training steps (N_ITER_TRAIN = 4 inner iterations
    each) on `device`; `callback(i, metrics)` runs after step i. `cfg` as in
    `flagship_trainer`; `lr_fn(i)` gives step i's lr (e.g.
    `solver.schedule.build_lr_fn`), else the base lr throughout. `batches`
    (an iterator of step batches on `device`) feeds step i its i-th batch,
    else every step takes the synthetic one. Returns (state, [metrics of each
    step]); the state names the trained parameters."""
    t = flagship_trainer(device, batch_size, seed, cfg, **model_overrides)
    history = []
    for i in range(steps):
        batch = t.batch if batches is None else next(batches)
        lr = t.lr if lr_fn is None else lr_fn(i)
        t.state, metrics = t.step(t.state, batch, t.generator, lr)
        history.append(metrics)
        if callback is not None:
            callback(i, metrics)
    return t.state, history


def train_from_split(records: list, steps: int, device="cuda", cfg=None, callback=None,
                     loader=None, **loader_kw):
    """`steps` flagship training steps on batches read from a split: the
    train loader (`shipped_train_loader` over `records` with `loader_kw`, or
    `loader`) -> `engine.runner.batch_to_device` (MAX_OBJS_TRAIN, KPS_TYPE)
    -> `train_entry` (`cfg` defaults to the shipped config). The model's
    point counts follow the loader's (with KPS_TYPE mean_shape the table of
    `mean_points` has `num_kps` points). The loader's part of a step is the
    `torch.profiler` range train.loader. Returns (state, [metrics of each
    step])."""
    cfg = load_config(str(FLAGSHIP_CONFIG)) if cfg is None else cfg
    if loader is None:
        loader = shipped_train_loader(records, device, cfg=cfg, **loader_kw)
    lcfg = loader.cfg

    def batches():
        raw = iter(loader)                      # a train loader has no end
        while True:
            with span("train.loader"):
                batch = batch_to_device(
                    next(raw), device, max_objs=int(cfg.DATALOADER.get("MAX_OBJS_TRAIN", 120)),
                    kps_type=lcfg.kps_type, num_kps=lcfg.num_kps,
                    with_neg_axis=bool(cfg.INPUT.get("WITH_NEG_AXIS", False)))
            yield batch

    return train_entry(device, steps=steps, callback=callback, cfg=cfg, batches=batches(),
                       num_pcl=lcfg.num_pcl, num_kps=lcfg.num_kps)
