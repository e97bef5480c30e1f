"""The train and test runners wired from a config tree.

Counterpart of `catre_tpu/engine/runner.py`: `_update_bad_iter` (:73),
`build_model` (:82), `filter_invalid_dicts` (:100), `get_train_dicts` (:124),
`batch_to_device` (:133), `do_train` (:191), `do_test` (:454),
`_log_train_vis` (:598), `_save_visualizations` (:637, on `utils/vis.py`),
`_save_results_pkl` (:707), `_add_canonical_init` (:723) and
`_add_gt_noise_init` (:743). Behavioural reference:
`core/catre/engine/engine.py` (`do_train` :164, `do_test` :131).

A training run goes config -> the model (MODEL.WEIGHTS) and its optimizer
(SOLVER, LR_MULT, FREEZE) -> the train loader over DATASETS.TRAIN (and
TRAIN2) -> per iteration the train step at the warm-up's refine count, with
the lr of the schedule -> the writers, periodic checkpoints under
OUTPUT_DIR/ckpt and periodic `do_test`. A test run goes config -> dataset
registry -> init poses -> `CATRELoader` -> the refine -> `CATREEvaluator`
-> `predictions.pkl` and the tables. Both run on the card unless the caller
asks for the CPU. The JAX package's `CATRE_EVAL_SLAB_GROUPS` is dropped
(item 15).

Over a process group (`parallel/launch.py`, one process per card) both run
on every process, as JAX's do over the processes of a mesh: SOLVER.IMS_PER_BATCH
and MAX_OBJS_TRAIN are global and split evenly, each process's train loader
reads its rank's stride of the stream, the train step sums over the group
(`engine/train.py`), the main process alone writes the metrics, tensorboard
and the checkpoints, and a periodic `do_test` runs on every process; in
`do_test` each process refines its contiguous share of the records
(`comm.inference_slice`) and the main process scores the gathered
predictions. NUM_CHIPS counts the processes a machine: a value the group
does not match raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import os.path as osp
import pickle
import shutil
import time

import numpy as np
import torch

from ..config.build import (loader_config_from, loss_config_from, model_config_from,
                            noise_config_from)
from ..data import meta
from ..data.kps import select_kps
from ..data.loader import CATRELoader
from ..data.nocs import get_dataset_dicts, load_init_poses_into_dataset
from ..engine.refiner import make_refine_fn
from ..engine.train import init_train_state, make_train_step
from ..eval.evaluator import CATREEvaluator, run_inference
from ..geom.symmetry import axis_symmetry_rotation_bank
from ..models.catre import init_model
from ..parallel import comm
from ..solver.build import optimizer_from_config
from ..solver.schedule import build_lr_fn
from ..utils import checkpoint as ckpt
from ..utils import profiler
from ..utils.events import EventStorage, JSONWriter, MetricPrinter, TensorboardWriter

logger = logging.getLogger(__name__)

GT_NOISE_SEED = 2025     # the CPU generator of the gt_noise test init (JAX: PRNGKey(2025))
STEP_SEED = 1000         # the train steps' generators: (STEP_SEED + SEED, iteration)
TRAIN2_STREAM = 5        # the TRAIN2 coin's stream: (SEED, TRAIN2_STREAM, iteration)
PROFILE_SKIP = 2         # iterations run before a TRAIN.PROFILE_ITERS trace, where there are


def _check_world(cfg, device: torch.device) -> None:
    """NUM_CHIPS processes a machine (0: one a card) must match the process
    group: one process drives one card, so N > 1 in a process without a
    group of N or more raises rather than run on one."""
    n = int(cfg.get("NUM_CHIPS", 1))
    if n == 0:   # 0 = every card, as in the JAX package
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    world = comm.get_world_size()
    if n > 1 and world % n:
        raise ValueError(f"NUM_CHIPS={n} processes a machine, and this process is in a group of "
                         f"{world}: start one process per card with `python -m "
                         f"catre_tpu_torch.main --num-chips {n}` (parallel/launch.py), or set "
                         "NUM_CHIPS=1")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} needs a CUDA card; pass device='cpu' (the CLI's "
                           "--device cpu) to run on the CPU")
    return dev


def build_model(cfg, device="cuda"):
    """The model of `cfg` on `device`, seeded from SEED (at least 0), then
    MODEL.WEIGHTS loaded when given (`utils.checkpoint.load_weights`): a .pth
    or .pkl in the reference's layout, an orbax directory of the JAX package
    (needs tensorstore) or a directory of the port's own checkpoints, each at
    its latest step. -> (model, its CATREConfig, seconds spent reading and
    loading the weights)."""
    mcfg = model_config_from(cfg)
    model = init_model(mcfg, seed=max(int(cfg.get("SEED", 0)), 0), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model %s: %.2fM parameters", cfg.MODEL.CATRE.NAME, n_params / 1e6)
    load_s = 0.0
    path = cfg.MODEL.get("WEIGHTS", "")
    if path:
        t0 = time.perf_counter()
        logger.info("loading the weights of %s", path)
        sd = ckpt.load_weights(path, model)
        model.load_state_dict(sd)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t0
        logger.info("weights loaded in %.3f s", load_s)
    return model, mcfg, load_s


def filter_invalid_dicts(dicts: list, visib_thr: float = 0.0) -> list:
    """Drop instances with visib_fract <= visib_thr and the images left empty
    (`filter_invalid_in_dataset_dicts`, `core/utils/dataset_utils.py:80-104`;
    an absent visib_fract counts as 1.0). The input is not changed."""
    num_filtered = 0
    out = []
    for rec in dicts:
        annos = rec.get("annotations")
        if annos is None:
            out.append(rec)
            continue
        kept = [a for a in annos if a.get("visib_fract", 1.0) > visib_thr]
        num_filtered += len(annos) - len(kept)
        if not kept:
            continue
        out.append(dict(rec, annotations=kept))
    if num_filtered > 0:
        logger.warning("filtered out %d instances with visib_fract <= %s", num_filtered,
                       visib_thr)
    return out


def get_train_dicts(cfg, names) -> list:
    """The records of the registered splits `names`, with the instances at
    or under DATALOADER.FILTER_VISIB_THR and the images left empty dropped."""
    dicts = []
    for name in names:
        dicts.extend(get_dataset_dicts(name))
    return filter_invalid_dicts(dicts, visib_thr=float(cfg.DATALOADER.get("FILTER_VISIB_THR",
                                                                          0.0)))


# the loader batch fields the train step reads
_TRAIN_KEYS = ("pcl", "obj_cls", "obj_pose", "obj_scale", "sym_flag", "valid", "obj_mean_points",
               "obj_mean_scales", "K")


def batch_to_device(batch: dict, device, max_objs: int | None = None,
                    kps_type: str = "mean_shape", num_kps: int = 1024,
                    with_neg_axis: bool = False) -> dict:
    """A train loader batch -> the train step's tensors on `device`: the
    fields it reads (and `last_frame_poses`, `obj_fps_points` where the
    batch has them), the first `max_objs` rows (DATALOADER.MAX_OBJS_TRAIN;
    a warning names the valid objects the cap drops), and `obj_kps` of
    `kps_type` at the gt scale. Under KPS_TYPE "fps" there is no `obj_kps`:
    the step divides `obj_fps_points` by its first scale estimate."""
    keep = list(_TRAIN_KEYS)
    if "last_frame_poses" in batch:
        keep.append("last_frame_poses")
    fps = kps_type.lower() == "fps"
    if fps:
        if "obj_fps_points" not in batch:
            raise ValueError("INPUT.KPS_TYPE='fps' but the batch carries no obj_fps_points: the "
                             "loader ships them only when its LoaderConfig.kps_type is 'fps' "
                             "(set by config.build.loader_config_from)")
        keep.append("obj_fps_points")
        if "obj_mean_points" not in batch:
            keep.remove("obj_mean_points")
    rows = batch["pcl"].shape[0]
    if max_objs is not None and rows > max_objs:
        dropped = int(np.sum(np.asarray(batch["valid"][max_objs:])))
        if dropped > 0:
            logger.warning("MAX_OBJS_TRAIN cap %d dropped %d valid instances (batch had %d "
                           "rows)", max_objs, dropped, rows)
    out = {}
    for k in keep:
        v = batch[k][:max_objs] if max_objs is not None else batch[k]
        out[k] = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray)
                                 else v).to(device)
    if not fps:
        out["obj_kps"] = select_kps(kps_type, mean_points=out.get("obj_mean_points"),
                                    scale_est=out["obj_scale"], num_kps=num_kps,
                                    with_neg_axis=with_neg_axis)
    return out


def _update_bad_iter(bad_iter: torch.Tensor, loss_vec: torch.Tensor, it: int) -> torch.Tensor:
    """The first iteration whose losses were not all finite, -1 while there
    is none: an int32 on the losses' device, updated each step without a
    host sync and read at the metric sync (the reference asserts every
    iteration, `engine.py:322`)."""
    return torch.where(~torch.isfinite(loss_vec).all() & (bad_iter < 0), it, bad_iter)


def step_generator(seed: int, iteration: int) -> torch.Generator:
    """The CPU generator of one iteration's init and augmentation draws,
    seeded from (STEP_SEED + seed, iteration) alone, as the JAX package folds
    the iteration into PRNGKey(1000 + seed): a resumed run draws what an
    uninterrupted one draws."""
    hi, lo = np.random.SeedSequence((STEP_SEED + seed, iteration)).generate_state(2)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def pick_train2(seed: int, iteration: int, ratio: float) -> bool:
    """Whether `iteration` reads the TRAIN2 loader: a coin drawn from (seed,
    5, iteration) alone (the reference draws from a stateful generator,
    `engine.py:280-283`; this one makes the stream positional for resume)."""
    return np.random.default_rng(
        np.random.SeedSequence((seed, TRAIN2_STREAM, iteration))).random() < ratio


def do_train(cfg, resume: bool = False, device="cuda"):
    """Train the model of `cfg` on DATASETS.TRAIN (mixed with TRAIN2 at
    TRAIN2_RATIO) for SOLVER.TOTAL_EPOCHS, on `device`. -> the final
    `TrainState` (its parameters are the model's).

    Per iteration: the epoch; the refine count n of the warm-up (1 up to
    N_ITER_TRAIN over the first N_ITER_TRAIN_WARM_EPOCH epochs); a loader
    batch capped at MAX_OBJS_TRAIN rows; the train step at n with the
    schedule's lr and `step_generator(SEED, iteration)`. Every PRINT_FREQ
    iterations and at the last the metrics are read from the device once
    (`iter{i}/<name>` for i < n, `loss_total` of the last inner iteration),
    a non-finite loss since the last read raises FloatingPointError, and the
    writers (log, OUTPUT_DIR/metrics.json, OUTPUT_DIR/tb) take them.
    OUTPUT_DIR/ckpt/step_<i>.pt holds the model and the optimizer every
    CHECKPOINT_PERIOD epochs (iterations without CHECKPOINT_BY_EPOCH) and at
    the last iteration; TEST.EVAL_PERIOD runs `do_test` on a copy of the
    weights, its model, loaders and refine kept from one evaluation to the
    next. `resume` restarts after the latest checkpoint there, the loaders
    moved on to where an uninterrupted run would read. TRAIN.PROFILE_ITERS =
    k traces k iterations into OUTPUT_DIR/profile; TRAIN.VIS_IMG queues the
    first valid object's keypoints on its image for tensorboard (at world 1).
    Over a process group every process calls it (see the module's
    docstring); each returns its state, the same on every process."""
    dev = _device(device)
    _check_world(cfg, dev)
    output_dir = cfg.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)

    model, mcfg, _ = build_model(cfg, dev)
    optimizer = optimizer_from_config(cfg, model)
    state = init_train_state(model, optimizer)

    # data: IMS_PER_BATCH is the global batch, ims_local images on each process
    world, rank = comm.get_world_size(), comm.get_rank()
    ims_per_batch = int(cfg.SOLVER.IMS_PER_BATCH)
    if ims_per_batch < 1:
        raise ValueError(f"SOLVER.IMS_PER_BATCH={ims_per_batch}: at least one image a step")
    if ims_per_batch % world:
        raise ValueError(f"SOLVER.IMS_PER_BATCH={ims_per_batch} does not split over {world} "
                         "processes")
    ims_local = ims_per_batch // world
    train_dicts = get_train_dicts(cfg, cfg.DATASETS.TRAIN)
    if not train_dicts:
        raise FileNotFoundError(f"no training data found for {cfg.DATASETS.TRAIN} under "
                                f"{meta.NOCS_ROOT}")
    seed = max(int(cfg.get("SEED", 0)), 0)
    loader_cfg = loader_config_from(cfg, "train")
    # the aligned NOCS / RGB paths read host pixel indices: no device batches
    # (JAX's single-process do_train asks for them there, and its loader refuses)
    devb = not (loader_cfg.with_nocs or loader_cfg.pcl_with_color)

    def train_loader(dicts, loader_seed):
        return CATRELoader(dicts, loader_cfg, phase="train", ims_per_batch=ims_local,
                           seed=loader_seed, num_workers=int(cfg.DATALOADER.get("NUM_WORKERS", 0)),
                           rank=rank, world_size=world, device_batches=devb, device=dev)

    loader = train_loader(train_dicts, seed)
    ratio = float(cfg.DATASETS.get("TRAIN2_RATIO", 0.0))
    loader2 = None
    if cfg.DATASETS.get("TRAIN2", ()) and ratio > 0:
        loader2 = train_loader(get_train_dicts(cfg, cfg.DATASETS.TRAIN2), 1 + seed)

    def use_train2(it: int) -> bool:
        return loader2 is not None and pick_train2(seed, it, ratio)

    iters_per_epoch = max(len(train_dicts) // ims_per_batch, 1)
    max_iter = int(cfg.SOLVER.TOTAL_EPOCHS) * iters_per_epoch
    lr_fn = build_lr_fn(dict(cfg.SOLVER), max_iter)
    logger.info("dataset %d images; %d iters/epoch; %d total iters", len(train_dicts),
                iters_per_epoch, max_iter)

    # one train step per refine count of the warm-up; n changes nothing else
    loss_cfg, noise_cfg = loss_config_from(cfg), noise_config_from(cfg)
    sym_bank = axis_symmetry_rotation_bank(
        max_sym_disc_step=float(cfg.INPUT.get("MAX_SYM_DISC_STEP", 0.01)))
    n_iter_train = max(1, int(cfg.MODEL.CATRE.N_ITER_TRAIN))
    warm_epochs = int(cfg.MODEL.CATRE.N_ITER_TRAIN_WARM_EPOCH)
    # the vis payload holds this process's rows: world 1 only, as in JAX
    with_vis = bool(cfg.TRAIN.get("VIS_IMG", False)) and world == 1
    steps = {}

    def step_at(n: int):
        if n not in steps:
            steps[n] = make_train_step(model, loss_cfg, noise_cfg, optimizer, sym_bank, n,
                                       with_vis=with_vis)
        return steps[n]

    # resume: the model, the optimizer and the step; the loaders fast-forwarded
    start_iter = 0
    ckpt_dir = osp.join(output_dir, "ckpt")
    if resume:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            saved = ckpt.load_checkpoint(ckpt_dir, latest)
            model.load_state_dict(saved["model"])
            optimizer.load_state_dict(saved["optimizer"])
            start_iter = latest + 1
            state = state._replace(step=start_iter)
            n2 = sum(use_train2(i) for i in range(start_iter))
            loader.skip((start_iter - n2) * ims_local)
            if loader2 is not None:
                loader2.skip(n2 * ims_local)
            logger.info("resumed from iteration %d (loader fast-forward: %d + %d batches)",
                        start_iter, start_iter - n2, n2)
    batches = iter(loader)
    batches2 = iter(loader2) if loader2 is not None else None

    ckpt_period = int(cfg.SOLVER.CHECKPOINT_PERIOD) * (
        iters_per_epoch if cfg.SOLVER.get("CHECKPOINT_BY_EPOCH", True) else 1)
    keep = int(cfg.SOLVER.get("MAX_TO_KEEP", 5))
    eval_period = int(cfg.TEST.get("EVAL_PERIOD", 0))
    # the evaluation's own model, loaders and refine, kept across evaluations
    eval_ctx = {"model": init_model(mcfg, device=dev)} if eval_period > 0 else None
    print_freq = int(cfg.TRAIN.get("PRINT_FREQ", 100))
    max_objs = int(cfg.DATALOADER.get("MAX_OBJS_TRAIN", 120)) // world    # a global cap
    kps_kw = dict(kps_type=cfg.INPUT.get("KPS_TYPE", "mean_shape"),
                  num_kps=int(cfg.INPUT.get("NUM_KPS", 1024)),
                  with_neg_axis=bool(cfg.INPUT.get("WITH_NEG_AXIS", False)))

    tb_dir = osp.join(output_dir, "tb")
    is_main = comm.is_main_process()
    if not resume and osp.isdir(tb_dir) and is_main:
        # a fresh run: the old tensorboard directory moved aside (`engine.py:152-161`)
        shutil.move(tb_dir, f"{tb_dir}_old_{int(time.time())}")
    storage = EventStorage(start_iter)
    # the writers are the main process's (`my_writer.py`); the metrics are global
    writers = [MetricPrinter(max_iter), JSONWriter(osp.join(output_dir, "metrics.json")),
               TensorboardWriter(tb_dir)] if is_main else []

    # TRAIN.PROFILE_ITERS = k: iterations [start + skip, start + skip + k) traced
    profile_iters = int(cfg.TRAIN.get("PROFILE_ITERS", 0))
    profile_dir = osp.join(output_dir, "profile")
    profile_start = start_iter + min(PROFILE_SKIP, max(0, max_iter - start_iter - profile_iters))
    tracing = contextlib.ExitStack()

    bad_iter = torch.full((), -1, dtype=torch.int32, device=dev)
    iter_t0 = None
    try:
        for iteration in range(start_iter, max_iter):
            if profile_iters > 0 and iteration == profile_start:
                tracing.callback(logger.info, "profiler trace written to %s", profile_dir)
                tracing.enter_context(profiler.trace(profile_dir, cuda=dev.type == "cuda"))
            elif profile_iters > 0 and iteration == profile_start + profile_iters:
                tracing.close()
            storage.iter = iteration
            epoch = iteration // iters_per_epoch + 1
            storage.put_scalar("epoch", epoch)
            n = n_iter_train
            if warm_epochs > 0:
                n = min(n, max(1, int(n_iter_train * epoch / warm_epochs)))

            raw = next(batches2 if use_train2(iteration) else batches)
            batch = batch_to_device(raw, dev, max_objs=max_objs, **kps_kw)
            if iter_t0 is not None:
                storage.put_scalar("time", time.perf_counter() - iter_t0)
            iter_t0 = time.perf_counter()

            lr = lr_fn(iteration)
            state, metrics = step_at(n)(state, batch, step_generator(seed, iteration), lr)
            bad_iter = _update_bad_iter(bad_iter, metrics["loss_total"], iteration)
            storage.put_scalar("lr", lr)

            if (iteration + 1) % print_freq == 0 or iteration == max_iter - 1:
                vis = metrics.pop("_vis", None)
                names = list(metrics)
                host = torch.cat([torch.stack([metrics[k] for k in names]).double().flatten(),
                                  bad_iter.double()[None]]).cpu().numpy()
                bad = int(host[-1])
                if bad >= 0:
                    raise FloatingPointError(f"non-finite loss first observed at iteration {bad} "
                                             f"(detected at iteration {iteration})")
                values = dict(zip(names, host[:-1].reshape(len(names), n)))
                for i in range(n):
                    for k, v in values.items():
                        storage.put_scalar(f"iter{i}/{k}", v[i])
                storage.put_scalar("loss_total", values["loss_total"][-1])
                if vis is not None:
                    try:
                        _log_train_vis(storage, raw, batch, vis)
                    except Exception as e:       # the vis never stops training
                        logger.warning("train vis failed: %s", e)
                for w in writers:
                    w.write(storage)

            if (iteration + 1) % ckpt_period == 0 or iteration == max_iter - 1:
                ckpt.save_checkpoint(ckpt_dir, iteration, {"model": model, "optimizer": optimizer},
                                     keep=keep)
            if eval_period > 0 and (iteration + 1) % eval_period == 0:
                do_test(cfg, params_override=model.state_dict(), ctx=eval_ctx, device=dev)
    finally:
        for w in writers:
            w.close()
        tracing.close()          # a run shorter than the trace: it ends with the loop
    logger.info("training done: %d iterations", max_iter)
    return state


def do_test(cfg, params_override=None, ctx: dict | None = None, device="cuda") -> dict:
    """Evaluate every dataset of DATASETS.TEST: {name: {"stats", "results"}},
    `run_inference`'s statistics (with `load_s`, the seconds of reading the
    weights) and the evaluator's per-iteration tables.

    `params_override` is a state dict loaded into the model before the run.
    `ctx` is a cache the caller owns ({} at first): the model, each dataset's
    loader (rewound with `reset_stream`, its decoded caches kept) and the
    refine survive from one call to the next, as periodic evaluation in
    training will reuse them; a call with a cached model needs
    `params_override`.

    Over a process group every process calls it: each refines its share of
    each dataset's records, and the main process scores them all and writes
    the files; the others return their statistics with empty results, as
    JAX's do."""
    dev = _device(device)
    _check_world(cfg, dev)
    output_dir = cfg.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)

    load_s = 0.0
    if ctx is not None and "model" in ctx:
        model = ctx["model"]
        if params_override is None:
            raise ValueError("a do_test call with a cached model needs params_override")
    else:
        model, _, load_s = build_model(cfg, dev)
        if ctx is not None:
            ctx["model"] = model
    if params_override is not None:
        model.load_state_dict(params_override)

    results_all = {}
    for dset_name in cfg.DATASETS.TEST:
        dicts = get_dataset_dicts(dset_name)
        # the evaluator's ground truth, kept before the init poses overwrite annotations
        for rec in dicts:
            rec["gt_annotations"] = [dict(a) for a in rec.get("annotations", [])]
        init_type = cfg.INPUT.get("INIT_POSE_TYPE_TEST", "est")
        if cfg.MODEL.get("LOAD_POSES_TEST", False) and cfg.DATASETS.get("INIT_POSE_FILES_TEST"):
            dicts = load_init_poses_into_dataset(
                dicts, cfg.DATASETS.INIT_POSE_FILES_TEST[0],
                score_thr=float(cfg.DATASETS.get("DET_THR", 0.0)))
        elif init_type == "gt_noise":
            _add_gt_noise_init(cfg, dicts)
        elif init_type == "canonical":
            _add_canonical_init(cfg, dicts)

        n_iter = int(cfg.MODEL.CATRE.N_ITER_TEST)
        evaluator = CATREEvaluator(dicts, n_iters=n_iter, output_dir=output_dir)
        # DATALOADER.FILTER_EMPTY_DETS (`data_loader.py:960-961`): images without
        # detections leave inference only; the evaluator keeps every ground truth
        if cfg.DATALOADER.get("FILTER_EMPTY_DETS", True):
            n_before = len(dicts)
            dicts = [r for r in dicts if r.get("annotations")]
            if len(dicts) < n_before:
                logger.info("FILTER_EMPTY_DETS: %d/%d images dropped", n_before - len(dicts),
                            n_before)

        if cfg.VAL.get("EVAL_CACHED", False) or cfg.VAL.get("EVAL_PRINT_ONLY", False):
            # re-score the cached predictions without the model
            # (`catre_custom_evaluator.py:74-79,226-235`)
            with open(osp.join(output_dir, "predictions.pkl"), "rb") as f:
                evaluator._preds = pickle.load(f)
            results_all[dset_name] = {"stats": {}, "results": evaluator.evaluate()}
            continue

        loader_cfg = loader_config_from(cfg, "test")
        ims_per_batch = int(cfg.TEST.get("IMS_PER_BATCH", 1))
        num_workers = int(cfg.DATALOADER.get("NUM_WORKERS", 0))
        lkey = ("test_loader", dset_name, ims_per_batch, num_workers, repr(loader_cfg), str(dev))
        if ctx is not None and lkey in ctx:
            loader = ctx[lkey]
            loader.reset_stream()
        else:
            # the aligned NOCS / RGB paths read host pixel indices: no device batches
            devb = not (loader_cfg.with_nocs or loader_cfg.pcl_with_color)
            # this process's contiguous share (InferenceSampler,
            # `my_distributed_sampler.py:172-200`), drawn as world 1 draws it
            loader = CATRELoader(dicts, loader_cfg, phase="test", ims_per_batch=ims_per_batch,
                                 num_workers=num_workers, device_batches=devb, device=dev,
                                 rank=comm.get_rank(), world_size=comm.get_world_size())
            if ctx is not None:
                ctx[lkey] = loader
        if ctx is not None and ("refine", n_iter) in ctx:
            refine = ctx[("refine", n_iter)]
        else:
            refine = make_refine_fn(model, n_iter)
            if ctx is not None:
                ctx[("refine", n_iter)] = refine
        stats = run_inference(
            refine, loader, evaluator, n_iter,
            kps_type=cfg.INPUT.get("KPS_TYPE", "mean_shape"),
            num_kps=int(cfg.INPUT.get("NUM_KPS", 1024)),
            # cmra + USE_CMRA_MODEL: the loader ships per-instance priors, which
            # the category table would override
            use_mean_table=not (bool(cfg.INPUT.get("USE_CMRA_MODEL", True))
                                and "cmra" in dset_name),
            device=dev)
        stats["load_s"] = load_s
        # the gathers are collective; the main process alone writes
        if cfg.TEST.get("VIS", False):
            evaluator.gather_predictions()
            if comm.is_main_process():
                _save_visualizations(dicts, evaluator, output_dir)
        if cfg.TEST.get("SAVE_RESULTS_ONLY", False):
            evaluator.gather_predictions()
            if comm.is_main_process():
                _save_results_pkl(evaluator, osp.join(output_dir, f"results_{dset_name}.pkl"))
            results = {}
        else:
            results = evaluator.evaluate()
        results_all[dset_name] = {"stats": stats, "results": results}
    return results_all


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _log_train_vis(storage, batch_np: dict, batch: dict, vis: dict) -> None:
    """TRAIN.VIS_IMG (`engine.py:370-422`): the first valid object's image,
    read as the loader reads colour (a missing file gives 480 x 640 of
    zeros), queued as input_image, and with its keypoints (times the gt
    scale under the gt pose, then times the last refine iteration's scale
    under its pose) drawn as red dots, as image_with_gt_kps and
    image_with_est_kps."""
    from ..data.loader import _read_colour
    from ..utils.vis import draw_projected_kps

    valid = _host(vis["valid"])
    if not valid.any():
        return
    idx = int(np.argmax(valid))
    im_id = int(_host(batch_np["im_id"])[idx]) if "im_id" in batch_np else 0
    file_names = batch_np.get("file_names", [])
    bgr = None
    if im_id < len(file_names) and file_names[im_id]:
        bgr = _read_colour(file_names[im_id])
    img = np.zeros((480, 640, 3), np.uint8) if bgr is None else np.ascontiguousarray(bgr[:, :, ::-1])
    kps, K = _host(batch["obj_kps"][idx]), _host(batch["K"][idx])
    gt_pose, gt_scale = _host(vis["gt_pose"][idx])[:3, :4], _host(vis["gt_scale"][idx])
    est_pose, est_scale = _host(vis["pose"][-1, idx])[:3, :4], _host(vis["scale"][-1, idx])
    storage.put_image("input_image", img)
    storage.put_image("image_with_gt_kps",
                      draw_projected_kps(img, kps, gt_scale, gt_pose, K, color=(255, 0, 0)))
    storage.put_image("image_with_est_kps",
                      draw_projected_kps(img, kps, est_scale, est_pose, K, color=(255, 0, 0)))


def _save_visualizations(dicts: list, evaluator: CATREEvaluator, output_dir: str,
                         n_images: int = 5) -> None:
    """TEST.VIS (the reference's save-results vis, `catre_evaluator.py:595-679`),
    for the first `n_images` scored images with a depth file, under
    OUTPUT_DIR/vis:
      - `<sid>.png`: the gt (red channel), init (yellow) and final (green)
        boxes on the depth as a JET heat map;
      - `<sid>_iters.png`: one panel a refine iteration, gt (blue), init (red)
        and that iteration's estimate (green) on the colour image when it
        reads, else on the heat map, tiled three a row. Panel titles are not
        rendered (`utils/vis.py`)."""
    from ..data.loader import load_depth
    from ..data.png import read_png, write_png
    from ..utils.vis import draw_projected_box3d, grid_show, heatmap

    vis_dir = osp.join(output_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    final_iter = evaluator.n_iters
    done = 0
    for rec in dicts:
        sid = rec["scene_im_id"]
        if sid not in evaluator._preds[final_iter] or "depth_file" not in rec:
            continue
        try:
            depth = load_depth(rec["depth_file"])
        except FileNotFoundError:
            continue
        img = heatmap(depth)
        K = np.asarray(rec["cam"])
        gt = evaluator._gts.get(sid, {})
        for RT, s in zip(gt.get("gt_RTs", []), gt.get("gt_scales", [])):
            img = draw_projected_box3d(img, s, RT[:3], K, color=(255, 0, 0))
        for it, color in [(0, (0, 255, 255)), (final_iter, (0, 255, 0))]:
            pred = evaluator._preds[it][sid]
            for RT, s in zip(pred["pred_RTs"], pred["pred_scales"]):
                img = draw_projected_box3d(img, s, RT[:3], K, color=color)
        write_png(osp.join(vis_dir, sid.replace("/", "_") + ".png"), img)

        base = None
        if rec.get("file_name"):
            try:
                bgr = read_png(rec["file_name"])
                if bgr.ndim == 3:
                    base = np.ascontiguousarray(bgr[:, :, ::-1])
            except (OSError, ValueError):
                base = None
        if base is None:
            base = heatmap(depth, to_rgb=True)
        panels, titles = [], []
        init = evaluator._preds[0][sid]
        for it in range(1, final_iter + 1):
            panel = base.copy()
            for RT, s in zip(gt.get("gt_RTs", []), gt.get("gt_scales", [])):
                panel = draw_projected_box3d(panel, s, RT[:3], K, color=(0, 0, 255))
            for RT, s in zip(init["pred_RTs"], init["pred_scales"]):
                panel = draw_projected_box3d(panel, s, RT[:3], K, color=(255, 0, 0))
            pred = evaluator._preds[it][sid]
            for RT, s in zip(pred["pred_RTs"], pred["pred_scales"]):
                panel = draw_projected_box3d(panel, s, RT[:3], K, color=(0, 255, 0))
            panels.append(panel)
            titles.append(f"im_init_refine_{it}")
        if panels:  # n_iters = 0 scores the init only: nothing to tile
            ncol = min(3, len(panels))
            grid_show(panels, titles, row=int(np.ceil(len(panels) / ncol)), col=ncol,
                      save_path=osp.join(vis_dir, sid.replace("/", "_") + "_iters.png"))
        done += 1
        if done >= n_images:
            break
    logger.info("saved %d visualizations to %s", done, vis_dir)


def _save_results_pkl(evaluator: CATREEvaluator, path: str) -> None:
    """results_<dataset>.pkl: per image the ground truth and the poses and
    scales of every iteration, keyed by scene_im_id (`catre_save_result_of_
    dataset`, `catre_evaluator.py:372-707`)."""
    out = {}
    for refine_i, preds in enumerate(evaluator._preds):
        for scene_im_id, p in preds.items():
            rec = out.setdefault(scene_im_id, dict(evaluator._gts.get(scene_im_id, {})))
            rec[f"pred_RTs_{refine_i}"] = p["pred_RTs"]
            rec[f"pred_scales_{refine_i}"] = p["pred_scales"]
            if refine_i == 0:
                rec.update({k: p[k] for k in ["pred_class_ids", "pred_scores", "pred_bboxes"]})
    with open(path, "wb") as f:
        pickle.dump(out, f)
    logger.info("saved results to %s", path)


def _add_canonical_init(cfg, dicts) -> None:
    """INIT_POSE_TYPE_TEST='canonical': every instance starts from the fixed
    pose and size INPUT.CANONICAL_ROT / TRANS / SIZE (the reference lists the
    mode, `data_loader.py:994`, but never maps it)."""
    from ..geom.rotations import rot_from_axangle_chain

    R = rot_from_axangle_chain(tuple(tuple(x) for x in cfg.INPUT.get(
        "CANONICAL_ROT", ((1, 0, 0, 0.5), (0, 0, 1, -0.7))))).numpy()
    t = np.asarray(cfg.INPUT.get("CANONICAL_TRANS", (0.0, 0.0, 1.0)), dtype=np.float64)
    size = np.asarray(cfg.INPUT.get("CANONICAL_SIZE", (0.2, 0.2, 0.2)), dtype=np.float64)
    pose = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
    for rec in dicts:
        for a in rec.get("annotations", []):
            a["pose_est"] = pose.copy()
            a["scale_est"] = size.astype(np.float32).copy()
            a["score"] = 1.0


def _add_gt_noise_init(cfg, dicts) -> None:
    """INIT_POSE_TYPE_TEST='gt_noise': each image's gt poses and scales
    perturbed into its init estimates (the validation mode,
    `data_loader.py:816-841`), one std of each test ladder drawn per image.
    The draws come from a CPU generator seeded GT_NOISE_SEED; they differ
    from the JAX package's threefry draws by design, as the loader's do."""
    from ..data.aug import aug_poses_normal, aug_scale_normal

    gen = torch.Generator().manual_seed(GT_NOISE_SEED)
    inp = cfg.INPUT
    for rec in dicts:
        annos = rec.get("annotations", [])
        if not annos:
            continue
        poses = torch.from_numpy(np.stack([a["pose"] for a in annos]).astype(np.float32))
        scales = torch.from_numpy(np.stack([a["scale"] for a in annos]).astype(np.float32))
        poses_n = aug_poses_normal(
            gen, poses, [float(inp.get("NOISE_ROT_STD_TEST", 15))],
            inp.get("NOISE_TRANS_STD_TEST"), max_rot=float(inp.get("NOISE_ROT_MAX_TEST", 45)),
            min_z=float(inp.get("INIT_TRANS_MIN_Z", 0.1))).numpy()
        scales_n = aug_scale_normal(gen, scales, inp.get("NOISE_SCALE_STD_TEST"),
                                    min_s=float(inp.get("INIT_SCALE_MIN", 0.04))).numpy()
        for i, a in enumerate(annos):
            a["pose_est"] = poses_n[i]
            a["scale_est"] = scales_n[i]
            a["score"] = 1.0
