"""Dataset evaluator: per-image predictions for refine iterations 0..N, scored
with the fixed-IoU NOCS protocol, and the timed inference loop that feeds it.

Counterpart of `catre_tpu/eval/evaluator.py`: `CATREEvaluator` (:38-205) and
`run_inference` (:207-588). `predictions.pkl` is written in the JAX layout (a
list over iterations of scene_im_id -> dict of numpy arrays, the same
dtypes), so either package re-scores the other's file.

Behavioral reference: `core/catre/engine/catre_custom_evaluator.py:33-330`
(reset / process / evaluate, the ground truth from the dataset dicts, the
per-iteration mAP tables) and `core/catre/engine/catre_evaluator.py:225-369`
(the timed inference loop).
"""

from __future__ import annotations

import collections
import logging
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from ..data import assets, meta
from ..data.kps import select_kps
from ..geom.transforms import pose_3x4_to_4x4_np
from ..parallel import comm
from .nocs_eval import SYNSET_NAMES, compute_independent_mAP

logger = logging.getLogger(__name__)

# the 12 headline metrics: (name, which table, its index)
_SUMMARY = (("IoU25", "iou", (-1, 1)), ("IoU50", "iou", (-1, 2)), ("IoU75", "iou", (-1, 3)),
            ("re5te2", "pose", (-1, 0, 0)), ("re5te5", "pose", (-1, 0, 1)),
            ("re10te2", "pose", (-1, 1, 0)), ("re10te5", "pose", (-1, 1, 1)),
            ("re10te10", "pose", (-1, 1, 2)), ("re5", "pose", (-1, 0, -1)),
            ("re10", "pose", (-1, 1, -1)), ("te2", "pose", (-1, -1, 0)),
            ("te5", "pose", (-1, -1, 1)))


class CATREEvaluator:
    """Accumulates predictions (per refine iteration) and computes the NOCS
    REAL275 metric tables."""

    def __init__(self, dataset_dicts: list, n_iters: int = 4, output_dir: str | None = None,
                 use_matches_for_pose: bool = True):
        self.n_iters = n_iters
        self.output_dir = output_dir
        self.use_matches_for_pose = use_matches_for_pose
        self._gts = self._build_gts(dataset_dicts)
        self.reset()

    @staticmethod
    def _build_gts(dataset_dicts: list) -> dict:
        """scene_im_id -> ground-truth dict (`catre_custom_evaluator.py:81-102`)."""
        gts = {}
        for rec in dataset_dicts:
            annos = rec.get("gt_annotations", rec.get("annotations", []))
            cls_ids, RTs, scales, handles = [], [], [], []
            for a in annos:
                if "pose" not in a:
                    continue
                cls_ids.append(a["category_id"] + 1)  # 1-based for the protocol
                RTs.append(pose_3x4_to_4x4_np(np.asarray(a["pose"], np.float32)))
                scales.append(a["scale"])
                handles.append(a.get("mug_handle", 1))
            gts[rec["scene_im_id"]] = {
                "gt_class_ids": np.asarray(cls_ids, dtype=np.int32),
                "gt_RTs": np.asarray(RTs).reshape(-1, 4, 4),
                "gt_scales": np.asarray(scales, dtype=np.float32).reshape(-1, 3),
                "gt_handle_visibility": np.asarray(handles, dtype=np.int32),
            }
        return gts

    def reset(self) -> None:
        # refine_i -> scene_im_id -> prediction dict
        self._preds = [dict() for _ in range(self.n_iters + 1)]
        self._gathered = False

    def process(self, scene_im_id: str, refine_i: int, poses_4x4: np.ndarray,
                scales: np.ndarray, class_ids_1based: np.ndarray,
                scores: np.ndarray, bboxes_yxyx: np.ndarray) -> None:
        """Store one image's predictions for one refine iteration
        (`catre_custom_evaluator.py:121-176`)."""
        # new local predictions make a later gather exchange them again
        self._gathered = False
        self._preds[refine_i][scene_im_id] = {
            "pred_RTs": np.asarray(poses_4x4),
            "pred_scales": np.asarray(scales),
            "pred_class_ids": np.asarray(class_ids_1based, dtype=np.int32),
            "pred_scores": np.asarray(scores),
            "pred_bboxes": np.asarray(bboxes_yxyx),
        }

    def gather_predictions(self) -> None:
        """Merge every process's predictions into each process's
        (`catre_custom_evaluator.py:200-213`). Collective over a process
        group (every process calls it); a no-op at world 1; a second call
        without new predictions exchanges nothing."""
        if comm.get_world_size() == 1 or self._gathered:
            return
        merged = [dict() for _ in range(self.n_iters + 1)]
        for proc_preds in comm.all_gather(self._preds):
            for refine_i, preds in enumerate(proc_preds):
                merged[refine_i].update(preds)
        self._preds = merged
        self._gathered = True

    def evaluate(self, dump: bool = True) -> dict:
        """Per-iteration mAP tables: {iter_i: {"iou_aps", "pose_aps",
        "summary"}}; with `dump` and an output_dir also `predictions.pkl` and
        one table a iteration. Over a process group the predictions are
        gathered (collective) and the main process alone scores and writes;
        the others return {}."""
        self.gather_predictions()
        if not comm.is_main_process():
            return {}
        # threshold lists of the reference evaluator (`catre_custom_evaluator.py:248-251`)
        iou_thres_list = [0.1, 0.25, 0.50, 0.75]
        degree_thres_list = [5, 10]
        shift_thres_list = [2, 5, 10]

        if dump and self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(osp.join(self.output_dir, "predictions.pkl"), "wb") as f:
                pickle.dump(self._preds, f)

        empty_pred = {
            "pred_RTs": np.zeros((0, 4, 4)),
            "pred_scales": np.zeros((0, 3)),
            "pred_class_ids": np.zeros(0, dtype=np.int32),
            "pred_scores": np.zeros(0),
            "pred_bboxes": np.zeros((0, 4)),
        }

        out = {}
        for refine_i in range(self.n_iters + 1):
            if not self._preds[refine_i]:
                continue
            # every ground-truth image; one without predictions gets empty ones
            # (`catre_custom_evaluator.py:239-246`)
            final_results = []
            for scene_im_id, gt in self._gts.items():
                result = dict(gt)
                result.update(self._preds[refine_i].get(scene_im_id, empty_pred))
                final_results.append(result)
            iou_aps, pose_aps = compute_independent_mAP(
                final_results, SYNSET_NAMES,
                degree_thresholds=degree_thres_list,
                shift_thresholds=shift_thres_list,
                iou_3d_thresholds=iou_thres_list,
                use_matches_for_pose=self.use_matches_for_pose,
            )
            # (deg, shift) indices; -1 = the appended 360 / 100 sentinel column
            tables = {"iou": iou_aps, "pose": pose_aps}
            summary = {name: tables[t][idx] * 100 for name, t, idx in _SUMMARY}
            out[refine_i] = {"iou_aps": iou_aps, "pose_aps": pose_aps, "summary": summary}
            logger.info("refine iter %d: %s", refine_i,
                        {k: round(v, 2) for k, v in summary.items()})
            if dump and self.output_dir:
                self._dump_table(refine_i, iou_aps, pose_aps)
        return out

    def _dump_table(self, refine_i: int, iou_aps, pose_aps) -> None:
        """Per-class table like the reference's tabulate dump
        (`catre_custom_evaluator.py:263-325`)."""
        tables = {"iou": iou_aps, "pose": pose_aps}
        rows = [["objects"] + meta.OBJECTS + ["Avg(6)"]]
        for name, t, idx in _SUMMARY:
            col = tables[t][(slice(None),) + idx[1:]]
            rows.append([name] + [f"{100*col[i]:.2f}" for i in range(1, 7)]
                        + [f"{100*col[-1]:.2f}"])
        widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
        lines = ["  ".join(v.ljust(widths[c]) for c, v in enumerate(r)) for r in rows]
        path = osp.join(self.output_dir, f"metrics_tab_iter{refine_i}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        logger.info("refine iter %d table:\n%s", refine_i, "\n".join(lines))


# ---- the inference loop

def pack_host(batch: dict, pin: bool = False) -> torch.Tensor:
    """A batch's host fields as one (B, 28) f32 row a object: pose 12, scale 3,
    K 9, mean scales 3, class 1 (small ints, exact in f32), as JAX
    `run_inference` packs them (:363-380). `pin` puts it in pinned memory,
    from which a copy to the card runs without a host wait."""
    b = len(batch["obj_cls"])
    packed = torch.from_numpy(np.concatenate([
        np.asarray(batch["obj_pose_est"], np.float32).reshape(b, 12),
        np.asarray(batch["obj_scale_est"], np.float32),
        np.asarray(batch["K"], np.float32).reshape(b, 9),
        np.asarray(batch["obj_mean_scales"], np.float32),
        np.asarray(batch["obj_cls"], np.float32)[:, None],
    ], axis=1))
    return packed.pin_memory() if pin else packed


def unpack_refine_args(pcl: torch.Tensor, table: torch.Tensor, packed: torch.Tensor) -> tuple:
    """(clouds, the (C, K, 3) mean-shape table, the packed rows on its device)
    -> the refine's arguments: the keypoints gathered by class, the init
    pose, scale, K and mean scales (each contiguous, as the host path gives
    them)."""
    b = packed.shape[0]
    return (pcl, table[packed[:, 27].long()], packed[:, :12].reshape(b, 3, 4).contiguous(),
            packed[:, 12:15].contiguous(), packed[:, 15:24].reshape(b, 3, 3).contiguous(),
            packed[:, 24:27].contiguous())


def run_inference(refine_fn, loader, evaluator: CATREEvaluator, n_iters: int, warmup: int = 1,
                  kps_type: str = "mean_shape", num_kps: int = 1024, mesh=None,
                  compute_probe_every: int = 8, prefetch: int = 2, use_mean_table: bool = True,
                  mean_table=None, device=None) -> dict:
    """Timed inference over a test loader (`catre_inference_on_dataset`,
    `catre_evaluator.py:225-369`): every batch through `refine_fn`
    (`engine.refiner.make_refine_fn`, its model on `device`, by default the
    loader's `device`), iterations 0 .. n_iters of each real image into
    `evaluator`; iteration 0 is the init.

    Inputs, two paths: with the mean-shape table (`mean_table`, else
    `data.assets.mean_shape_array()`; sent to the device once), one (B, 28)
    row (`pack_host`) goes up in one copy and the keypoints are gathered
    there by class (the shipped path); without a table (no asset file,
    another `kps_type`, `use_mean_table=False` for per-instance priors),
    `data.kps.select_kps` runs on the host over the fields the loader ships
    and each field goes up on its own.

    `prefetch` refine results stay in flight: each is copied without a host
    wait into pinned host buffers (a ring of prefetch + 1) and an event is
    recorded behind the copy; the host bookkeeping of a result waits on its
    event only. Every `compute_probe_every`-th batch after `warmup` is a
    probe: the results in flight are finished, then upload + refine are
    timed between two device synchronisations (`compute_s_per_img`, the
    reference's cuda-synchronised figure); `overlap_fetch_s_per_img` is the
    overlapped dispatch-to-fetch attribution, `process_s_per_img` the host
    bookkeeping. 0 turns probing off.

    Not ported: `mesh` (instance rows sharded over the devices of one
    process, ROADMAP item 15: one process per card replaces it, each with its
    share of the records) raises; `slab_groups` (several loader groups a
    dispatch) and batches carrying `_presampled` (the loader's
    `defer_selection`) are item 15, and such a batch raises."""
    if mesh is not None:
        raise NotImplementedError("run_inference(mesh=...) is not ported (ROADMAP item 15): "
                                  "one process per card, each with its share of the records")
    loader_dev = getattr(loader, "device", None)
    if device is None and loader_dev is None:
        raise ValueError("run_inference: a loader without a device needs device=")
    dev = torch.device(loader_dev if device is None else device)
    if dev.type == "cuda" and dev.index is None:    # "cuda" names the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    if loader_dev is not None and torch.device(loader_dev).type != dev.type:
        raise ValueError(f"run_inference: the loader is on {loader_dev}, the refine on {dev}; "
                         f"both must be on one device")
    cuda = dev.type == "cuda"

    def put(a) -> torch.Tensor:
        """Host numpy -> the refine's device, through pinned memory on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(dev, non_blocking=True) if cuda else t

    def put_pcl(pcl) -> torch.Tensor:
        if not torch.is_tensor(pcl):
            return put(pcl)
        if pcl.device != dev:
            raise ValueError(f"run_inference: the clouds are on {pcl.device}, the refine on "
                             f"{dev}; both must be on one device")
        return pcl

    table = None
    if kps_type.lower() == "mean_shape" and use_mean_table:
        if mean_table is None:
            try:
                mean_table = assets.mean_shape_array()
            except FileNotFoundError:
                pass  # no asset pickles: the per-batch host path
        if mean_table is not None and mean_table.shape[1] == num_kps:
            table = torch.as_tensor(mean_table, dtype=torch.float32).to(dev)

    total_compute = 0.0
    total_process = 0.0
    n_images = 0
    probe_s = 0.0
    probe_images = 0
    ring = [None] * (prefetch + 1)
    start = time.perf_counter()

    def fetch(slot, poses, scales):
        """Start the copy of one result to the host; -> (poses, scales, event).
        The refine returns f32 (the init's dtype, also under bf16), as JAX's
        device_get gives it; `float()` keeps it so."""
        poses, scales = poses.float(), scales.float()
        if not cuda:
            return poses, scales, None
        bufs = ring[slot]
        if bufs is None or bufs[0].shape != poses.shape or bufs[1].shape != scales.shape:
            bufs = ring[slot] = (torch.empty(poses.shape, pin_memory=True),
                                 torch.empty(scales.shape, pin_memory=True))
        bufs[0].copy_(poses, non_blocking=True)
        bufs[1].copy_(scales, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return bufs[0], bufs[1], event

    def finish(entry):
        """Wait for one result's copy and run the host bookkeeping."""
        nonlocal total_compute, total_process, n_images
        i, batch, poses, scales, event, t0 = entry
        if event is not None:
            event.synchronize()
        poses, scales = poses.numpy(), scales.numpy()
        if i >= warmup:
            total_compute += time.perf_counter() - t0
            # real images, not slots: a trailing group's padding has no scene_im_id
            n_images += sum(1 for s in batch["scene_im_ids"] if s is not None)

        t1 = time.perf_counter()
        valid = np.asarray(batch["valid"])
        im_ids = np.asarray(batch["im_id"])
        cls_all = np.asarray(batch["obj_cls"]) + 1
        scores_all = np.asarray(batch["score"])
        bb_all = np.asarray(batch["obj_bbox"])[:, [1, 0, 3, 2]]  # xyxy -> yxyx
        for local_i, scene_im_id in enumerate(batch["scene_im_ids"]):
            if scene_im_id is None:  # a trailing group's padding image
                continue
            sel = np.flatnonzero(valid & (im_ids == local_i))
            for refine_i in range(n_iters + 1):
                evaluator.process(scene_im_id, refine_i,
                                  pose_3x4_to_4x4_np(poses[refine_i][sel]),
                                  scales[refine_i][sel], cls_all[sel], scores_all[sel],
                                  bb_all[sel])
        if i >= warmup:
            total_process += time.perf_counter() - t1

    def refine(batch):
        if table is not None:
            packed = pack_host(batch, pin=cuda).to(dev, non_blocking=True)
            return refine_fn(*unpack_refine_args(put_pcl(batch["pcl"]), table, packed))
        if kps_type.lower() == "mean_shape" and "obj_mean_points" not in batch:
            raise ValueError(
                "batch lacks obj_mean_points but the device kps-table "
                "path is inactive — build the loader with "
                "ship_mean_points=True for this kps_type/num_kps")
        if kps_type.lower() == "fps" and "obj_fps_points" not in batch:
            raise ValueError(
                "INPUT.KPS_TYPE='fps' but the batch carries no "
                "obj_fps_points — build the loader from a config with "
                "KPS_TYPE='fps' (ref data_loader.py:737-752)")
        obj_kps = put(select_kps(kps_type, mean_points=batch.get("obj_mean_points"),
                                 scale_est=batch["obj_scale_est"],
                                 fps_points=batch.get("obj_fps_points"), num_kps=num_kps))
        return refine_fn(put_pcl(batch["pcl"]), obj_kps, put(batch["obj_pose_est"]),
                         put(batch["obj_scale_est"]), put(batch["K"]),
                         put(batch["obj_mean_scales"]))

    pending = collections.deque()
    i = -1
    for batch in loader:
        if batch.get("empty"):
            continue
        if batch.get("_presampled") is not None:
            raise NotImplementedError("run_inference: a batch with _presampled (the loader's "
                                      "defer_selection) is not ported (ROADMAP item 15)")
        i += 1
        probe = (compute_probe_every > 0 and i >= warmup
                 and (i - warmup) % compute_probe_every == 0)
        if probe:
            while pending:  # drain, so that the probe times this batch's work only
                finish(pending.popleft())
            if cuda:
                torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        poses, scales = refine(batch)
        if probe:
            if cuda:
                torch.cuda.synchronize(dev)
            probe_s += time.perf_counter() - t0
            probe_images += sum(1 for s in batch["scene_im_ids"] if s is not None)
        pending.append((i, batch, *fetch(i % len(ring), poses, scales), t0))
        if len(pending) > prefetch:
            finish(pending.popleft())
    while pending:
        finish(pending.popleft())

    wall = time.perf_counter() - start
    stats = {
        "images": n_images,
        "total_s": wall,
        # synchronised device compute of the probe batches (the reference's
        # meaning, catre_evaluator.py:312-319)
        "compute_s_per_img": probe_s / probe_images if probe_images else
        total_compute / max(n_images, 1),
        # overlapped dispatch -> fetch attribution (the pipeline's view)
        "overlap_fetch_s_per_img": total_compute / max(n_images, 1),
        "process_s_per_img": total_process / max(n_images, 1),
    }
    logger.info("inference stats: %s", stats)
    return stats
