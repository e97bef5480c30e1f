"""The test runner wired from a config tree.

Counterpart of the test half of `catre_tpu/engine/runner.py`: `build_model`
(:82), `filter_invalid_dicts` (:100), `do_test` (:454), `_save_visualizations`
(:637, on `utils/vis.py`), `_save_results_pkl` (:707), `_add_canonical_init`
(:723) and `_add_gt_noise_init` (:743).
Behavioural reference: `core/catre/engine/engine.py::do_test` (:131).

A test run goes config -> dataset registry -> init poses -> `CATRELoader`
-> the refine -> `CATREEvaluator` -> `predictions.pkl` and the tables, on
the card unless the caller asks for the CPU. What the port does not do yet
raises and names its ROADMAP item: training (`do_train`, item 13b), more
than one device or process (`NUM_CHIPS` > 1, a process group of world > 1:
item 14). The JAX package's `CATRE_EVAL_SLAB_GROUPS` is dropped (item 15).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from ..config.build import loader_config_from, model_config_from
from ..data.loader import CATRELoader
from ..data.nocs import get_dataset_dicts, load_init_poses_into_dataset
from ..engine.refiner import make_refine_fn
from ..eval.evaluator import CATREEvaluator, run_inference
from ..models.catre import init_model
from ..utils import checkpoint as ckpt

logger = logging.getLogger(__name__)

GT_NOISE_SEED = 2025     # the CPU generator of the gt_noise test init (JAX: PRNGKey(2025))


def _check_single_device(cfg, device: torch.device) -> None:
    """One device and one process: anything more is ROADMAP item 14."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("do_test over a process group of world > 1 (each process a "
                                  "shard, predictions gathered) is not ported: ROADMAP item 14")
    n = int(cfg.get("NUM_CHIPS", 1))
    if n == 0:   # 0 = every device, as in the JAX package
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        raise NotImplementedError(f"NUM_CHIPS={n}: evaluation sharded over several devices is "
                                  "not ported (ROADMAP item 14); set NUM_CHIPS=1 (--num-chips 1)")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} needs a CUDA card; pass device='cpu' (the CLI's "
                           "--device cpu) to run on the CPU")
    return dev


def build_model(cfg, device="cuda"):
    """The model of `cfg` on `device`, seeded from SEED (at least 0), then
    MODEL.WEIGHTS loaded when given: a path ending in .pth or .pkl is a
    checkpoint in the reference's layout (`utils.checkpoint.
    load_reference_checkpoint`), any other path a directory of the port's own
    checkpoints (the latest step). -> (model, its CATREConfig, seconds spent
    reading and loading the weights)."""
    mcfg = model_config_from(cfg)
    model = init_model(mcfg, seed=max(int(cfg.get("SEED", 0)), 0), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model %s: %.2fM parameters", cfg.MODEL.CATRE.NAME, n_params / 1e6)
    load_s = 0.0
    path = cfg.MODEL.get("WEIGHTS", "")
    if path:
        t0 = time.perf_counter()
        if path.endswith((".pth", ".pkl")):
            logger.info("loading a reference checkpoint %s", path)
            sd = ckpt.load_reference_checkpoint(path, model)
        else:
            logger.info("loading a checkpoint of the port from %s", path)
            sd = ckpt.load_checkpoint(path)["model"]
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


def do_train(cfg, resume: bool = False, device="cuda"):
    raise NotImplementedError("training from a config (do_train: the loader's train phase, "
                              "schedules, periodic checkpoints and evaluation, --resume) is not "
                              "ported: ROADMAP item 13b; run with --eval-only")


def do_test(cfg, params_override=None, ctx: dict | None = None, device="cuda") -> dict:
    """Evaluate every dataset of DATASETS.TEST: {name: {"stats", "results"}},
    `run_inference`'s statistics (with `load_s`, the seconds of reading the
    weights) and the evaluator's per-iteration tables.

    `params_override` is a state dict loaded into the model before the run.
    `ctx` is a cache the caller owns ({} at first): the model, each dataset's
    loader (rewound with `reset_stream`, its decoded caches kept) and the
    refine survive from one call to the next, as periodic evaluation in
    training will reuse them; a call with a cached model needs
    `params_override`."""
    dev = _device(device)
    _check_single_device(cfg, dev)
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
            loader = CATRELoader(dicts, loader_cfg, phase="test", ims_per_batch=ims_per_batch,
                                 num_workers=num_workers, device_batches=True, device=dev)
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
        if cfg.TEST.get("VIS", False):
            evaluator.gather_predictions()
            _save_visualizations(dicts, evaluator, output_dir)
        if cfg.TEST.get("SAVE_RESULTS_ONLY", False):
            evaluator.gather_predictions()
            _save_results_pkl(evaluator, osp.join(output_dir, f"results_{dset_name}.pkl"))
            results = {}
        else:
            results = evaluator.evaluate()
        results_all[dset_name] = {"stats": stats, "results": results}
    return results_all


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
