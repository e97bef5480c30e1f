"""Evaluation: the fixed-IoU NOCS protocol (`nocs_eval`), the evaluator that
scores per-iteration predictions and the timed inference loop that feeds it
(`evaluator`). Counterpart of `catre_tpu/eval/`."""

from .evaluator import CATREEvaluator, run_inference
from .nocs_eval import (
    SYNSET_NAMES,
    compute_3d_iou_new,
    compute_RT_degree_cm_symmetry,
    compute_ap_from_matches_scores,
    compute_independent_mAP,
)

__all__ = [
    "CATREEvaluator", "run_inference", "SYNSET_NAMES", "compute_3d_iou_new",
    "compute_RT_degree_cm_symmetry", "compute_ap_from_matches_scores",
    "compute_independent_mAP",
]
