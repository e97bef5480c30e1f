"""NOCS fixed-IoU evaluation protocol.

A numpy copy of `catre_tpu/eval/nocs_eval.py`, bit-equal to it: the per-pair
IoU and rotation / translation errors (`get_3d_bbox` :23 ... `compute_3d_iou_new`
:90, the vectorised `pairwise_3d_ious` :128 and `pairwise_degree_cm` :175,
`compute_RT_degree_cm_symmetry` :233), the greedy matching and AP
(`compute_3d_matches` :287, `compute_independent_mAP` :377), the combination
protocol (:518-:694) and the standalone scorer (`evaluate` :695, `_main` :733),
run as `python -m catre_tpu_torch.eval.nocs_eval results.pkl`.

Behavioral reference: `core/catre/engine/test_utils.py` --
`compute_3d_iou_new:140` (the FIXED 3D IoU: axis-aligned bounds via
amax(axis=1); symmetric classes take the max over 20 y-rotations),
`compute_3d_matches:523`, `compute_RT_degree_cm_symmetry:619`,
`compute_match_from_degree_cm:715`, `compute_independent_mAP:760`,
`compute_ap_from_matches_scores:112`.

Greedy matching and AP accumulation stay in exact host numpy (tie-breaking
order matters); per-pair IoU/error computations are vectorized.
"""

from __future__ import annotations

import math

import numpy as np

SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]


def get_3d_bbox(scale, shift=0) -> np.ndarray:
    """(3, 8) corner coordinates of a scale-sized box (`test_utils.py:190-231`)."""
    s = np.asarray(scale, dtype=np.float64)
    corners = np.array(
        [
            [s[0] / 2, +s[1] / 2, s[2] / 2],
            [s[0] / 2, +s[1] / 2, -s[2] / 2],
            [-s[0] / 2, +s[1] / 2, s[2] / 2],
            [-s[0] / 2, +s[1] / 2, -s[2] / 2],
            [+s[0] / 2, -s[1] / 2, s[2] / 2],
            [+s[0] / 2, -s[1] / 2, -s[2] / 2],
            [-s[0] / 2, -s[1] / 2, s[2] / 2],
            [-s[0] / 2, -s[1] / 2, -s[2] / 2],
        ]
    ) + shift
    return corners.T


def transform_coordinates_3d(coordinates: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """(3, N), (4, 4) -> (3, N) with homogeneous divide (`test_utils.py:237-249`)."""
    assert coordinates.shape[0] == 3
    ones = np.ones((1, coordinates.shape[1]), dtype=coordinates.dtype)
    new = RT @ np.vstack([coordinates, ones])
    return new[:3, :] / new[3, :]


def _aabb_iou(RT_1, RT_2, scales_1, scales_2) -> float:
    """Axis-aligned IoU of two transformed boxes — the FIXED variant
    (bounds over axis=1, `test_utils.py:158-175`)."""
    b1 = transform_coordinates_3d(get_3d_bbox(scales_1, 0), RT_1)
    b2 = transform_coordinates_3d(get_3d_bbox(scales_2, 0), RT_2)
    b1_min, b1_max = b1.min(axis=1), b1.max(axis=1)
    b2_min, b2_max = b2.min(axis=1), b2.max(axis=1)
    omin = np.maximum(b1_min, b2_min)
    omax = np.minimum(b1_max, b2_max)
    if np.amin(omax - omin) < 0:
        intersection = 0.0
    else:
        intersection = np.prod(omax - omin)
    union = np.prod(b1_max - b1_min) + np.prod(b2_max - b2_min) - intersection
    return float(intersection / union)


_Y_ROTS_20 = None


def _y_rots_20():
    global _Y_ROTS_20
    if _Y_ROTS_20 is None:
        n = 20
        mats = []
        for i in range(n):
            theta = 2 * math.pi * i / float(n)
            mats.append(
                np.array(
                    [
                        [np.cos(theta), 0, np.sin(theta), 0],
                        [0, 1, 0, 0],
                        [-np.sin(theta), 0, np.cos(theta), 0],
                        [0, 0, 0, 1],
                    ]
                )
            )
        _Y_ROTS_20 = mats
    return _Y_ROTS_20


def compute_3d_iou_new(RT_1, RT_2, scales_1, scales_2, handle_visibility,
                       class_name_1, class_name_2) -> float:
    """Fixed NOCS 3D IoU with the 20-rotation symmetric max
    (`test_utils.py:140-205`)."""
    if RT_1 is None or RT_2 is None:
        return -1.0
    symmetric = (
        class_name_1 in ("bottle", "bowl", "can") and class_name_1 == class_name_2
    ) or (class_name_1 == "mug" and class_name_1 == class_name_2 and handle_visibility == 0)
    if symmetric:
        max_iou = 0.0
        for yrot in _y_rots_20():
            max_iou = max(max_iou, _aabb_iou(RT_1 @ yrot, RT_2, scales_1, scales_2))
        return max_iou
    return _aabb_iou(RT_1, RT_2, scales_1, scales_2)


def _box_bounds(RTs: np.ndarray, scales: np.ndarray):
    """AABB bounds of transformed scale boxes, batched over leading dims.

    RTs: (..., 4, 4), scales: (..., 3) -> (min (..., 3), max (..., 3)).
    Same arithmetic as `_aabb_iou`'s per-box step (hom transform of the 8
    corners, bounds over the corner axis) vectorized over all boxes.
    """
    s = np.asarray(scales, dtype=np.float64)
    # (..., 8, 3) signed corner pattern matching get_3d_bbox's corner order
    signs = np.array(
        [[1, 1, 1], [1, 1, -1], [-1, 1, 1], [-1, 1, -1],
         [1, -1, 1], [1, -1, -1], [-1, -1, 1], [-1, -1, -1]], dtype=np.float64)
    corners = signs * (s[..., None, :] / 2.0)  # (..., 8, 3)
    ones = np.ones(corners.shape[:-1] + (1,), dtype=np.float64)
    hom = np.concatenate([corners, ones], axis=-1)  # (..., 8, 4)
    # (..., 4, 4) @ (..., 4, 8) -> (..., 4, 8)
    out = np.einsum("...ij,...nj->...in", np.asarray(RTs, dtype=np.float64), hom)
    pts = out[..., :3, :] / out[..., 3:4, :]
    return pts.min(axis=-1), pts.max(axis=-1)


def pairwise_3d_ious(pred_RTs, pred_scales, gt_RTs, gt_scales,
                     sym_pair: np.ndarray) -> np.ndarray:
    """Vectorized (num_pred, num_gt) matrix of `compute_3d_iou_new` values.

    sym_pair: (num_pred, num_gt) bool — pair uses the 20-y-rotation max.
    Replaces the O(P*G*20) python loop of the reference
    (`test_utils.py:560-575` calling `:140-205` per pair); verified 1e-9
    against the scalar protocol in tests/test_eval.py.
    """
    P, G = len(pred_RTs), len(gt_RTs)
    if P == 0 or G == 0:
        return np.zeros((P, G), dtype=np.float64)
    pred_RTs = np.asarray(pred_RTs, dtype=np.float64)
    gt_RTs = np.asarray(gt_RTs, dtype=np.float64)
    yrots = np.stack(_y_rots_20())  # (20, 4, 4); index 0 is identity
    # (P, 20, 4, 4): prediction boxes under each symmetry rotation
    RT_rot = np.einsum("pij,rjk->prik", pred_RTs, yrots)
    pmin, pmax = _box_bounds(RT_rot, np.broadcast_to(
        np.asarray(pred_scales, np.float64)[:, None, :], (P, 20, 3)))
    gmin, gmax = _box_bounds(gt_RTs, gt_scales)  # (G, 3)

    omin = np.maximum(pmin[:, :, None, :], gmin[None, None, :, :])  # (P, 20, G, 3)
    omax = np.minimum(pmax[:, :, None, :], gmax[None, None, :, :])
    edge = omax - omin
    inter = np.where(edge.min(axis=-1) < 0, 0.0, np.prod(edge, axis=-1))  # (P, 20, G)
    vol_p = np.prod(pmax - pmin, axis=-1)  # (P, 20)
    vol_g = np.prod(gmax - gmin, axis=-1)  # (G,)
    union = vol_p[:, :, None] + vol_g[None, None, :] - inter
    ious = inter / union  # (P, 20, G)

    # symmetric pairs: max over rotations, floored at 0 (ref starts max_iou=0);
    # non-symmetric: rotation 0 (identity) only
    return np.where(sym_pair, np.maximum(ious.max(axis=1), 0.0), ious[:, 0, :])


def _sym_pair_mask(pred_class_ids, gt_class_ids, gt_handle_visibility,
                   synset_names) -> np.ndarray:
    """(P, G) mask of pairs evaluated with the symmetric 20-rotation max
    (`test_utils.py:178-201` condition)."""
    pred_names = np.array([synset_names[int(c)] for c in pred_class_ids])
    gt_names = np.array([synset_names[int(c)] for c in gt_class_ids])
    same = pred_names[:, None] == gt_names[None, :]
    gt_sym_always = np.isin(gt_names, ("bottle", "bowl", "can"))
    gt_sym_mug = (gt_names == "mug") & (np.asarray(gt_handle_visibility) == 0)
    return same & (gt_sym_always | gt_sym_mug)[None, :]


def pairwise_degree_cm(pred_RTs, gt_RTs, gt_class_ids, gt_handle_visibility,
                       synset_names=SYNSET_NAMES) -> np.ndarray:
    """Vectorized (num_pred, num_gt, 2) table of
    `compute_RT_degree_cm_symmetry` values (`test_utils.py:619-689`);
    replaces the per-pair loop of `compute_RT_overlaps` (`:692-713`)."""
    P, G = len(pred_RTs), len(gt_RTs)
    if P == 0 or G == 0:
        return np.zeros((P, G, 2), dtype=np.float64)
    RT1 = np.asarray(pred_RTs, dtype=np.float64)
    RT2 = np.asarray(gt_RTs, dtype=np.float64)
    for RT in (RT1, RT2):
        assert np.array_equal(
            RT[:, 3, :], np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (RT.shape[0], 1))
        ), RT

    R1 = RT1[:, :3, :3] / np.cbrt(np.linalg.det(RT1[:, :3, :3]))[:, None, None]
    T1 = RT1[:, :3, 3]
    R2 = RT2[:, :3, :3] / np.cbrt(np.linalg.det(RT2[:, :3, :3]))[:, None, None]
    T2 = RT2[:, :3, 3]

    gt_names = np.array([synset_names[int(c)] for c in gt_class_ids])
    sym = np.isin(gt_names, ("bottle", "can", "bowl")) | (
        (gt_names == "mug") & (np.asarray(gt_handle_visibility) == 0)
    )  # (G,)
    sym180 = np.isin(gt_names, ("phone", "eggbox", "glue"))  # (G,)

    # symmetric: angle between rotated y axes, no clip (parity with the
    # reference, `test_utils.py:664-667`)
    y1 = R1[:, :, 1]  # R @ [0,1,0] = second column
    y2 = R2[:, :, 1]
    dots = y1 @ y2.T  # (P, G)
    norms = np.linalg.norm(y1, axis=1)[:, None] * np.linalg.norm(y2, axis=1)[None, :]
    with np.errstate(invalid="ignore"):
        theta_sym = np.arccos(dots / norms)

    # 180-degree symmetric (phone/eggbox/glue): min over the y-flip, no clip
    # (`test_utils.py:668-678`)
    tr = np.einsum("pik,gik->pg", R1, R2)  # trace(R1 @ R2.T)
    y180 = np.diag([-1.0, 1.0, -1.0])
    tr180 = np.einsum("pij,jk,gik->pg", R1, y180, R2)  # trace(R1 @ y180 @ R2.T)
    with np.errstate(invalid="ignore"):
        t1 = np.arccos((tr - 1.0) / 2.0)
        t2 = np.arccos((tr180 - 1.0) / 2.0)
        # python min(t1, t2) semantics, not np.minimum: a NaN SECOND arg
        # (flip trace epsilon-outside [-1,1]) yields t1, a NaN first arg
        # propagates — matches the scalar reference exactly
        theta_180 = np.where(np.isnan(t2), t1, np.minimum(t1, t2))

    # general: trace formula with clip (`test_utils.py:679-683`)
    theta_gen = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))

    theta = np.where(
        sym[None, :], theta_sym,
        np.where(sym180[None, :], theta_180, theta_gen)) * 180.0 / np.pi
    shift = np.linalg.norm(T1[:, None, :] - T2[None, :, :], axis=-1) * 100.0
    return np.stack([theta, shift], axis=-1)


def compute_RT_degree_cm_symmetry(RT_1, RT_2, class_id, handle_visibility,
                                  synset_names=SYNSET_NAMES):
    """(theta deg, shift cm) with y-axis symmetry handling
    (`test_utils.py:619-689`)."""
    if RT_1 is None or RT_2 is None:
        return -1
    assert np.array_equal(RT_1[3, :], np.array([0, 0, 0, 1])), RT_1
    assert np.array_equal(RT_2[3, :], np.array([0, 0, 0, 1])), RT_2

    R1 = RT_1[:3, :3] / np.cbrt(np.linalg.det(RT_1[:3, :3]))
    T1 = RT_1[:3, 3]
    R2 = RT_2[:3, :3] / np.cbrt(np.linalg.det(RT_2[:3, :3]))
    T2 = RT_2[:3, 3]

    cname = synset_names[class_id]
    if cname in ("bottle", "can", "bowl") or (cname == "mug" and handle_visibility == 0):
        y = np.array([0, 1, 0])
        y1, y2 = R1 @ y, R2 @ y
        theta = np.arccos(y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2)))
    elif cname in ("phone", "eggbox", "glue"):
        y_180 = np.diag([-1.0, 1.0, -1.0])
        R = R1 @ R2.T
        R_rot = R1 @ y_180 @ R2.T
        theta = min(np.arccos((np.trace(R) - 1) / 2), np.arccos((np.trace(R_rot) - 1) / 2))
    else:
        R = R1 @ R2.T
        theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    return np.array([theta * 180 / np.pi, np.linalg.norm(T1 - T2) * 100])


def trim_zeros(x: np.ndarray) -> np.ndarray:
    """Strictly shape-preserving (the reference asserts no all-zero rows,
    `test_utils.py:32-47`)."""
    assert x.ndim == 2, x.shape
    new_x = x[~np.all(x == 0, axis=1)]
    assert new_x.shape == x.shape, "zero-padded rows are not allowed here"
    return new_x


def compute_ap_from_matches_scores(pred_match, pred_scores, gt_match) -> float:
    """VOC-style AP (`test_utils.py:112-137`)."""
    assert pred_match.shape[0] == pred_scores.shape[0]
    order = np.argsort(pred_scores)[::-1]
    pred_match = pred_match[order]
    precisions = np.cumsum(pred_match > -1) / (np.arange(len(pred_match)) + 1)
    recalls = np.cumsum(pred_match > -1).astype(np.float32) / len(gt_match)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = np.maximum(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    return float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))


def compute_3d_matches(gt_class_ids, gt_RTs, gt_scales, gt_handle_visibility,
                       synset_names, pred_boxes, pred_class_ids, pred_scores,
                       pred_RTs, pred_scales, iou_3d_thresholds, score_threshold=0):
    """Greedy IoU matching (`test_utils.py:523-616`). Returns
    (gt_matches, pred_matches, overlaps, sort_indices)."""
    num_pred = len(pred_class_ids)
    num_gt = len(gt_class_ids)
    indices = np.zeros(0)
    if num_pred:
        pred_boxes = trim_zeros(np.asarray(pred_boxes)).copy()
        pred_scores = np.asarray(pred_scores)[: pred_boxes.shape[0]].copy()
        indices = np.argsort(pred_scores)[::-1]
        pred_boxes = pred_boxes[indices].copy()
        pred_class_ids = np.asarray(pred_class_ids)[indices].copy()
        pred_scores = pred_scores[indices].copy()
        pred_scales = np.asarray(pred_scales)[indices].copy()
        pred_RTs = np.asarray(pred_RTs)[indices].copy()

    if num_pred and num_gt:
        sym_pair = _sym_pair_mask(pred_class_ids, gt_class_ids,
                                  gt_handle_visibility, synset_names)
        overlaps = pairwise_3d_ious(
            pred_RTs, pred_scales, gt_RTs, gt_scales, sym_pair
        ).astype(np.float32)
    else:
        overlaps = np.zeros((num_pred, num_gt), dtype=np.float32)

    num_thres = len(iou_3d_thresholds)
    pred_matches = -1 * np.ones([num_thres, num_pred])
    gt_matches = -1 * np.ones([num_thres, num_gt])
    for s, iou_thres in enumerate(iou_3d_thresholds):
        for i in range(len(pred_boxes)):
            sorted_ixs = np.argsort(overlaps[i])[::-1]
            low = np.where(overlaps[i, sorted_ixs] < score_threshold)[0]
            if low.size > 0:
                sorted_ixs = sorted_ixs[: low[0]]
            for j in sorted_ixs:
                if gt_matches[s, j] > -1:
                    continue
                iou = overlaps[i, j]
                if iou < iou_thres:
                    break
                if not pred_class_ids[i] == gt_class_ids[j]:
                    continue
                if iou > iou_thres:
                    gt_matches[s, j] = i
                    pred_matches[s, i] = j
                    break
    return gt_matches, pred_matches, overlaps, indices


def compute_RT_overlaps(gt_class_ids, gt_RTs, gt_handle_visibility,
                        pred_class_ids, pred_RTs, synset_names):
    """(num_pred, num_gt, 2) degree/cm error table (`test_utils.py:692-713`),
    computed by the vectorized pairwise kernel."""
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    if num_pred == 0 or num_gt == 0:
        return np.zeros((num_pred, num_gt, 2))
    return pairwise_degree_cm(
        np.asarray(pred_RTs), np.asarray(gt_RTs), gt_class_ids,
        gt_handle_visibility, synset_names,
    )


def compute_match_from_degree_cm(overlaps, pred_class_ids, gt_class_ids,
                                 degree_thres_list, shift_thres_list):
    """Greedy degree/cm matching (`test_utils.py:716-758`)."""
    num_deg, num_shift = len(degree_thres_list), len(shift_thres_list)
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    pred_matches = -1 * np.ones((num_deg, num_shift, num_pred))
    gt_matches = -1 * np.ones((num_deg, num_shift, num_gt))
    if num_pred == 0 or num_gt == 0:
        return gt_matches, pred_matches

    for d, degree_thres in enumerate(degree_thres_list):
        for s, shift_thres in enumerate(shift_thres_list):
            for i in range(num_pred):
                sum_ds = np.sum(overlaps[i, :, :], axis=-1)
                sorted_ixs = np.argsort(sum_ds)
                for j in sorted_ixs:
                    if gt_matches[d, s, j] > -1 or pred_class_ids[i] != gt_class_ids[j]:
                        continue
                    if overlaps[i, j, 0] > degree_thres or overlaps[i, j, 1] > shift_thres:
                        continue
                    gt_matches[d, s, j] = i
                    pred_matches[d, s, i] = j
                    break
    return gt_matches, pred_matches


def compute_independent_mAP(final_results, synset_names=SYNSET_NAMES,
                            degree_thresholds=(360,), shift_thresholds=(100,),
                            iou_3d_thresholds=(0.1,), iou_pose_thres=0.1,
                            use_matches_for_pose=True):
    """The NOCS protocol's top level (`test_utils.py:760-924`).

    Args:
      final_results: list of per-image dicts with gt_class_ids, gt_RTs,
        gt_scales, gt_handle_visibility, pred_bboxes, pred_class_ids,
        pred_scales, pred_scores, pred_RTs.
    Returns:
      (iou_3d_aps (C+1, n_iou), pose_aps (C+1, n_deg, n_shift)); last row is
      the class mean.
    """
    num_classes = len(synset_names)
    degree_thres_list = list(degree_thresholds) + [360]
    shift_thres_list = list(shift_thresholds) + [100]
    iou_thres_list = list(iou_3d_thresholds)
    num_deg, num_shift, num_iou = len(degree_thres_list), len(shift_thres_list), len(iou_thres_list)
    if use_matches_for_pose:
        assert iou_pose_thres in iou_thres_list

    iou_3d_aps = np.zeros((num_classes + 1, num_iou))
    iou_pred_matches_all = [np.zeros((num_iou, 0)) for _ in range(num_classes)]
    iou_pred_scores_all = [np.zeros((num_iou, 0)) for _ in range(num_classes)]
    iou_gt_matches_all = [np.zeros((num_iou, 0)) for _ in range(num_classes)]
    pose_aps = np.zeros((num_classes + 1, num_deg, num_shift))
    pose_pred_matches_all = [np.zeros((num_deg, num_shift, 0)) for _ in range(num_classes)]
    pose_gt_matches_all = [np.zeros((num_deg, num_shift, 0)) for _ in range(num_classes)]
    pose_pred_scores_all = [np.zeros((num_deg, num_shift, 0)) for _ in range(num_classes)]

    for result in final_results:
        gt_class_ids = np.asarray(result["gt_class_ids"]).astype(np.int32)
        gt_RTs = np.array(result["gt_RTs"])
        gt_scales = np.array(result["gt_scales"])
        gt_handle_visibility = np.asarray(result["gt_handle_visibility"])
        pred_bboxes = np.array(result["pred_bboxes"])
        pred_class_ids = np.asarray(result["pred_class_ids"])
        pred_scales = np.asarray(result["pred_scales"])
        pred_scores = np.asarray(result["pred_scores"])
        pred_RTs = np.array(result["pred_RTs"])

        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in range(1, num_classes):
            g = gt_class_ids == cls_id
            p = pred_class_ids == cls_id if len(pred_class_ids) else np.zeros(0, bool)
            cls_gt_class_ids = gt_class_ids[g] if len(gt_class_ids) else np.zeros(0)
            cls_gt_scales = gt_scales[g] if len(gt_class_ids) else np.zeros((0, 3))
            cls_gt_RTs = gt_RTs[g] if len(gt_class_ids) else np.zeros((0, 4, 4))
            cls_pred_class_ids = pred_class_ids[p] if len(pred_class_ids) else np.zeros(0)
            cls_pred_bboxes = pred_bboxes[p, :] if len(pred_class_ids) else np.zeros((0, 4))
            cls_pred_scores = pred_scores[p] if len(pred_class_ids) else np.zeros(0)
            cls_pred_RTs = pred_RTs[p] if len(pred_class_ids) else np.zeros((0, 4, 4))
            cls_pred_scales = pred_scales[p] if len(pred_class_ids) else np.zeros((0, 3))

            if synset_names[cls_id] != "mug":
                cls_gt_handle_visibility = np.ones_like(cls_gt_class_ids)
            else:
                cls_gt_handle_visibility = (
                    gt_handle_visibility[g] if len(gt_class_ids) else np.ones(0)
                )

            iou_cls_gt_match, iou_cls_pred_match, _, iou_pred_indices = compute_3d_matches(
                cls_gt_class_ids, cls_gt_RTs, cls_gt_scales, cls_gt_handle_visibility,
                synset_names, cls_pred_bboxes, cls_pred_class_ids, cls_pred_scores,
                cls_pred_RTs, cls_pred_scales, iou_thres_list,
            )
            if len(iou_pred_indices):
                cls_pred_class_ids = cls_pred_class_ids[iou_pred_indices]
                cls_pred_RTs = cls_pred_RTs[iou_pred_indices]
                cls_pred_scores = cls_pred_scores[iou_pred_indices]
                cls_pred_bboxes = cls_pred_bboxes[iou_pred_indices]

            iou_pred_matches_all[cls_id] = np.concatenate(
                (iou_pred_matches_all[cls_id], iou_cls_pred_match), axis=-1
            )
            tile = np.tile(cls_pred_scores, (num_iou, 1))
            iou_pred_scores_all[cls_id] = np.concatenate(
                (iou_pred_scores_all[cls_id], tile), axis=-1
            )
            iou_gt_matches_all[cls_id] = np.concatenate(
                (iou_gt_matches_all[cls_id], iou_cls_gt_match), axis=-1
            )

            if use_matches_for_pose:
                thres_ind = iou_thres_list.index(iou_pose_thres)
                m = iou_cls_pred_match[thres_ind, :]
                cls_pred_class_ids = cls_pred_class_ids[m > -1] if len(m) > 0 else np.zeros(0)
                cls_pred_RTs = cls_pred_RTs[m > -1] if len(m) > 0 else np.zeros((0, 4, 4))
                cls_pred_scores = cls_pred_scores[m > -1] if len(m) > 0 else np.zeros(0)
                cls_pred_bboxes = cls_pred_bboxes[m > -1] if len(m) > 0 else np.zeros((0, 4))
                gm = iou_cls_gt_match[thres_ind, :]
                cls_gt_class_ids = cls_gt_class_ids[gm > -1] if len(gm) > 0 else np.zeros(0)
                cls_gt_RTs = cls_gt_RTs[gm > -1] if len(gm) > 0 else np.zeros((0, 4, 4))
                cls_gt_handle_visibility = (
                    cls_gt_handle_visibility[gm > -1] if len(gm) > 0 else np.zeros(0)
                )

            RT_overlaps = compute_RT_overlaps(
                cls_gt_class_ids, cls_gt_RTs, cls_gt_handle_visibility,
                cls_pred_class_ids, cls_pred_RTs, synset_names,
            )
            pose_cls_gt_match, pose_cls_pred_match = compute_match_from_degree_cm(
                RT_overlaps, cls_pred_class_ids, cls_gt_class_ids,
                degree_thres_list, shift_thres_list,
            )
            pose_pred_matches_all[cls_id] = np.concatenate(
                (pose_pred_matches_all[cls_id], pose_cls_pred_match), axis=-1
            )
            tile = np.tile(cls_pred_scores, (num_deg, num_shift, 1))
            pose_pred_scores_all[cls_id] = np.concatenate(
                (pose_pred_scores_all[cls_id], tile), axis=-1
            )
            pose_gt_matches_all[cls_id] = np.concatenate(
                (pose_gt_matches_all[cls_id], pose_cls_gt_match), axis=-1
            )

    for cls_id in range(1, num_classes):
        for s in range(num_iou):
            iou_3d_aps[cls_id, s] = compute_ap_from_matches_scores(
                iou_pred_matches_all[cls_id][s, :], iou_pred_scores_all[cls_id][s, :],
                iou_gt_matches_all[cls_id][s, :],
            )
    iou_3d_aps[-1, :] = np.mean(iou_3d_aps[1:-1, :], axis=0)

    for i in range(num_deg):
        for j in range(num_shift):
            for cls_id in range(1, num_classes):
                pose_aps[cls_id, i, j] = compute_ap_from_matches_scores(
                    pose_pred_matches_all[cls_id][i, j, :],
                    pose_pred_scores_all[cls_id][i, j, :],
                    pose_gt_matches_all[cls_id][i, j, :],
                )
            pose_aps[-1, i, j] = np.mean(pose_aps[1:-1, i, j])

    return iou_3d_aps, pose_aps


# ---------------------------------------------------------------- combination
def compute_combination_RT_degree_cm_symmetry(RT_1, RT_2, scale, class_id,
                                              handle_visibility, synset_names):
    """Joint-protocol pose error (`test_utils.py:208-280`): degrees plus
    SCALE-NORMALIZED translation shift (||t1-t2|| / scale — no x100 cm)."""
    if RT_1 is None or RT_2 is None:
        return np.array([-1.0, -1.0])
    assert np.array_equal(RT_1[3, :], RT_2[3, :])
    assert np.array_equal(RT_1[3, :], np.array([0, 0, 0, 1]))

    R1 = RT_1[:3, :3] / np.cbrt(np.linalg.det(RT_1[:3, :3]))
    T1 = RT_1[:3, 3]
    R2 = RT_2[:3, :3] / np.cbrt(np.linalg.det(RT_2[:3, :3]))
    T2 = RT_2[:3, 3]

    cname = synset_names[class_id]
    if cname in ["bottle", "can", "bowl"] or (cname == "mug" and handle_visibility == 0):
        y = np.array([0.0, 1.0, 0.0])
        y1, y2 = R1 @ y, R2 @ y
        theta = np.arccos(y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2)))
    elif cname in ["phone", "eggbox", "glue"]:
        y_180 = np.diag([-1.0, 1.0, -1.0])
        R = R1 @ R2.T
        R_rot = R1 @ y_180 @ R2.T
        theta = min(np.arccos((np.trace(R) - 1) / 2),
                    np.arccos((np.trace(R_rot) - 1) / 2))
    else:
        R = R1 @ R2.T
        theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    theta *= 180.0 / np.pi
    shift = np.linalg.norm(T1 - T2) / scale
    return np.array([theta, shift])


def compute_combination_3d_matches(gt_class_ids, gt_RTs, gt_scales,
                                   gt_handle_visibility, synset_names,
                                   pred_boxes, pred_class_ids, pred_scores,
                                   pred_RTs, pred_scales, iou_3d_thresholds,
                                   degree_thresholds, shift_thresholds,
                                   score_threshold=0):
    """Greedy JOINT matching — a pair matches only when IoU, degree and
    normalized shift all pass together (`test_utils.py:283-392`)."""
    num_pred = len(pred_class_ids)
    num_gt = len(gt_class_ids)
    indices = np.zeros(0)
    if num_pred:
        pred_boxes = trim_zeros(np.asarray(pred_boxes)).copy()
        pred_scores = np.asarray(pred_scores)[: pred_boxes.shape[0]].copy()
        indices = np.argsort(pred_scores)[::-1]
        pred_boxes = pred_boxes[indices].copy()
        pred_class_ids = np.asarray(pred_class_ids)[indices].copy()
        pred_scores = pred_scores[indices].copy()
        pred_scales = np.asarray(pred_scales)[indices].copy()
        pred_RTs = np.asarray(pred_RTs)[indices].copy()

    overlaps = np.zeros((num_pred, num_gt), dtype=np.float32)
    RT_overlaps = np.zeros((num_pred, num_gt, 2), dtype=np.float32)
    for i in range(num_pred):
        for j in range(num_gt):
            overlaps[i, j] = compute_3d_iou_new(
                pred_RTs[i], gt_RTs[j], pred_scales[i, :], gt_scales[j],
                gt_handle_visibility[j], synset_names[pred_class_ids[i]],
                synset_names[gt_class_ids[j]])
            RT_overlaps[i, j, :] = compute_combination_RT_degree_cm_symmetry(
                pred_RTs[i], gt_RTs[j],
                np.cbrt(np.linalg.det(gt_RTs[j, :3, :3])),
                gt_class_ids[j], gt_handle_visibility[j], synset_names)

    num_iou, num_deg, num_shift = (len(iou_3d_thresholds),
                                   len(degree_thresholds), len(shift_thresholds))
    pred_matches = -1 * np.ones([num_deg, num_shift, num_iou, num_pred])
    gt_matches = -1 * np.ones([num_deg, num_shift, num_iou, num_gt])
    for s, iou_thres in enumerate(iou_3d_thresholds):
        for d, degree_thres in enumerate(degree_thresholds):
            for t, shift_thres in enumerate(shift_thresholds):
                for i in range(len(pred_boxes)):
                    sorted_ixs = np.argsort(overlaps[i])[::-1]
                    low = np.where(overlaps[i, sorted_ixs] < score_threshold)[0]
                    if low.size > 0:
                        sorted_ixs = sorted_ixs[: low[0]]
                    for j in sorted_ixs:
                        if gt_matches[d, t, s, j] > -1:
                            continue
                        iou = overlaps[i, j]
                        r_err, t_err = RT_overlaps[i, j]
                        # reference short-circuit: stop scanning this
                        # prediction once ANY criterion fails
                        # (`test_utils.py:375-380`)
                        if iou < iou_thres or r_err > degree_thres or t_err > shift_thres:
                            break
                        if not pred_class_ids[i] == gt_class_ids[j]:
                            continue
                        gt_matches[d, t, s, j] = i
                        pred_matches[d, t, s, i] = j
                        break
    return gt_matches, pred_matches, indices


def compute_combination_mAP(final_results, synset_names=SYNSET_NAMES,
                            degree_thresholds=(5, 10, 15),
                            shift_thresholds=(0.1, 0.2),
                            iou_3d_thresholds=(0.1,)):
    """Joint (IoU AND degree AND shift) mAP (`test_utils.py:394-520`).
    Returns aps (C+1, n_deg+1, n_shift+1, n_iou); last class row is the
    class mean."""
    num_classes = len(synset_names)
    degree_thres_list = list(degree_thresholds) + [360]
    shift_thres_list = list(shift_thresholds) + [100]
    iou_thres_list = list(iou_3d_thresholds)
    num_deg, num_shift, num_iou = (len(degree_thres_list),
                                   len(shift_thres_list), len(iou_thres_list))

    aps = np.zeros((num_classes + 1, num_deg, num_shift, num_iou))
    pred_matches_all = [np.zeros((num_deg, num_shift, num_iou, 0)) for _ in range(num_classes)]
    gt_matches_all = [np.zeros((num_deg, num_shift, num_iou, 0)) for _ in range(num_classes)]
    pred_scores_all = [np.zeros((num_deg, num_shift, num_iou, 0)) for _ in range(num_classes)]

    for result in final_results:
        gt_class_ids = np.asarray(result["gt_class_ids"]).astype(np.int32)
        gt_RTs = np.array(result["gt_RTs"])
        gt_scales = np.array(result["gt_scales"])
        gt_handle_visibility = np.asarray(result["gt_handle_visibility"])
        pred_bboxes = np.array(result["pred_bboxes"])
        pred_class_ids = np.asarray(result["pred_class_ids"])
        pred_scales = np.asarray(result["pred_scales"])
        pred_scores = np.asarray(result["pred_scores"])
        pred_RTs = np.array(result["pred_RTs"])
        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in range(1, num_classes):
            g = gt_class_ids == cls_id
            p = pred_class_ids == cls_id if len(pred_class_ids) else np.zeros(0, bool)
            cls_gt_class_ids = gt_class_ids[g] if len(gt_class_ids) else np.zeros(0)
            cls_gt_scales = gt_scales[g] if len(gt_class_ids) else np.zeros((0, 3))
            cls_gt_RTs = gt_RTs[g] if len(gt_class_ids) else np.zeros((0, 4, 4))
            cls_pred_class_ids = pred_class_ids[p] if len(pred_class_ids) else np.zeros(0)
            cls_pred_bboxes = pred_bboxes[p, :] if len(pred_class_ids) else np.zeros((0, 4))
            cls_pred_scores = pred_scores[p] if len(pred_class_ids) else np.zeros(0)
            cls_pred_RTs = pred_RTs[p] if len(pred_class_ids) else np.zeros((0, 4, 4))
            cls_pred_scales = pred_scales[p] if len(pred_class_ids) else np.zeros((0, 3))
            if synset_names[cls_id] != "mug":
                cls_gt_handle_visibility = np.ones_like(cls_gt_class_ids)
            else:
                cls_gt_handle_visibility = (
                    gt_handle_visibility[g] if len(gt_class_ids) else np.ones(0))

            gt_match, pred_match, pred_indices = compute_combination_3d_matches(
                cls_gt_class_ids, cls_gt_RTs, cls_gt_scales,
                cls_gt_handle_visibility, synset_names,
                cls_pred_bboxes, cls_pred_class_ids, cls_pred_scores,
                cls_pred_RTs, cls_pred_scales,
                iou_thres_list, degree_thres_list, shift_thres_list)
            if len(pred_indices):
                cls_pred_scores = cls_pred_scores[pred_indices]

            pred_matches_all[cls_id] = np.concatenate(
                (pred_matches_all[cls_id], pred_match), axis=-1)
            scores_tile = np.tile(cls_pred_scores,
                                  (num_deg, num_shift, num_iou, 1))
            pred_scores_all[cls_id] = np.concatenate(
                (pred_scores_all[cls_id], scores_tile), axis=-1)
            gt_matches_all[cls_id] = np.concatenate(
                (gt_matches_all[cls_id], gt_match), axis=-1)

    for cls_id in range(1, num_classes):
        for s in range(num_iou):
            for d in range(num_deg):
                for t in range(num_shift):
                    aps[cls_id, d, t, s] = compute_ap_from_matches_scores(
                        pred_matches_all[cls_id][d, t, s, :],
                        pred_scores_all[cls_id][d, t, s, :],
                        gt_matches_all[cls_id][d, t, s, :])
    aps[-1, :, :, :] = np.mean(aps[1:-1, :, :, :], axis=0)
    return aps


# ---------------------------------------------------------------- standalone
def evaluate(path, combination=False):
    """Score a results pkl — per-image dicts (or a dict of them) with
    gt_*/pred_* keys — the tool the reference uses on third-party result
    files (SPD/DualPoseNet; `test_utils.py:927-965`). Prints the headline
    table and returns (iou_3d_aps, pose_aps)."""
    import pickle

    with open(path, "rb") as f:
        final_results = pickle.load(f)
    if isinstance(final_results, dict):
        final_results = list(final_results.values())

    if combination:
        aps = compute_combination_mAP(final_results, SYNSET_NAMES,
                                      degree_thresholds=[5, 10, 20],
                                      shift_thresholds=[0.05, 0.1, 0.2],
                                      iou_3d_thresholds=[0.25, 0.50, 0.75])
        print("IoU75, 5 degree, 5% translation:  {:.2f}".format(aps[-1, 0, 0, 2] * 100))
        print("IoU75, 10 degree, 5% translation: {:.2f}".format(aps[-1, 1, 0, 2] * 100))
        print("IoU50, 10 degree, 10% translation: {:.2f}".format(aps[-1, 1, 1, 1] * 100))
        return aps

    iou_thres_list = [0.10, 0.25, 0.50, 0.75]
    degree_thres_list = [5, 10]
    shift_thres_list = [2, 5]
    iou_3d_aps, pose_aps = compute_independent_mAP(
        final_results, SYNSET_NAMES, degree_thresholds=degree_thres_list,
        shift_thresholds=shift_thres_list, iou_3d_thresholds=iou_thres_list)
    print("3D IoU at 25: {:.1f}".format(iou_3d_aps[-1, 1] * 100))
    print("3D IoU at 50: {:.1f}".format(iou_3d_aps[-1, 2] * 100))
    print("3D IoU at 75: {:.1f}".format(iou_3d_aps[-1, 3] * 100))
    print("5 degree, 2cm: {:.1f}".format(pose_aps[-1, 0, 0] * 100))
    print("5 degree, 5cm: {:.1f}".format(pose_aps[-1, 0, 1] * 100))
    print("10 degree, 2cm: {:.1f}".format(pose_aps[-1, 1, 0] * 100))
    print("10 degree, 5cm: {:.1f}".format(pose_aps[-1, 1, 1] * 100))
    return iou_3d_aps, pose_aps


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Standalone NOCS scorer for results pkls "
                    "(python -m catre_tpu_torch.eval.nocs_eval results.pkl)")
    p.add_argument("path")
    p.add_argument("--combination", action="store_true",
                   help="joint IoU+degree+shift mAP instead of independent")
    args = p.parse_args(argv)
    evaluate(args.path, combination=args.combination)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
