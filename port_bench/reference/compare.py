"""The numbers compared between the program and the reference."""

from __future__ import annotations

import math
import statistics

import torch


def rotation_gap_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """The largest angle between two stacks of rotations (..., 3, 3), in
    degrees, from the chord: ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2)."""
    chord = (Ra.double() - Rb.double()).flatten(-2).norm(dim=-1) / (2 * math.sqrt(2))
    return math.degrees(2 * math.asin(min(1.0, float(chord.max())))) if chord.numel() else 0.0


def pose_gaps(poses, scales, ref_poses, ref_scales) -> dict:
    """Widest gaps over every object and iteration: rotation (degrees),
    translation and scale (mm); infinite where the two hold different
    numbers of objects."""
    if poses.shape != ref_poses.shape or scales.shape != ref_scales.shape:
        return dict.fromkeys(("rot_gap_deg", "trans_gap_mm", "scale_gap_mm"), math.inf)
    return {
        "rot_gap_deg": rotation_gap_deg(poses[..., :3], ref_poses[..., :3]),
        "trans_gap_mm": 1e3 * float((poses[..., 3].double() - ref_poses[..., 3].double())
                                    .norm(dim=-1).max()),
        "scale_gap_mm": 1e3 * float((scales.double() - ref_scales.double()).abs().max()),
    }


def loss_gap(history: list, ref_history: list) -> float:
    """The widest gap of a loss term over every step and inner iteration,
    as a share of that iteration's total reference loss."""
    worst = 0.0
    for got, ref in zip(history, ref_history):
        total = sum(v.double() for v in ref.values())
        for k, v in ref.items():
            gap = (got[k].double().to(v.device) - v.double()).abs()
            worst = max(worst, float((gap / total.abs()).max()))
    return worst


def leaf_gaps(got: dict, ref: dict, keep: list) -> list:
    """Each leaf's gap of norms, |‖got‖ - ‖ref‖|, over the leaves in `keep`,
    against the larger of its reference norm and the median leaf's."""
    norms = {n: float(ref[n].double().norm()) for n in keep}
    median = statistics.median(norms.values())
    return [abs(float(got[n].double().norm()) - norms[n]) / max(norms[n], median)
            for n in keep]


def leaf_diffs(got: dict, ref: dict, keep: list) -> list:
    """Each leaf's ‖got - ref‖ over the leaves in `keep`, against the larger
    of its reference norm and the median leaf's: for one step taken from
    the same inputs, where the two should agree to rounding."""
    norms = {n: float(ref[n].double().norm()) for n in keep}
    median = statistics.median(norms.values())
    return [float((got[n].double() - ref[n].double()).norm()) / max(norms[n], median, 1e-30)
            for n in keep]


def moving_leaves(ref_grads: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: a norm
    of at least `share` of the median leaf's."""
    norms = {n: float(g.double().norm()) for n, g in ref_grads.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= share * median]


STATE = ("exp_avg", "exp_avg_sq", "slow")


def train_gaps(got, ref, follows: bool) -> dict:
    """The numbers compared between two runs of the same outer steps, each
    (loss terms, Ranger records, poses) in `reference.train.train_steps`'
    shape: `got` the program's, `ref` the reference's, which either trained
    on its own (`follows` False) or followed the program step by step.

    loss_gap: the widest loss term's gap, over every step and inner
    iteration, as a share of that iteration's total. grad_gap: over every
    Ranger step, the median leaf's gap of gradient norms (`leaf_gaps`), the
    widest; grad_gap_worst_leaf: the worst leaf of any step; grad_gap_first:
    the worst leaf of the first step. rot_gap_deg, trans_gap_mm,
    scale_gap_mm: the iteration-0 poses and every inner iteration's pose and
    scale. Following: update_gap, the worst leaf's ||delta - delta_ref|| of
    any Ranger step, and state_gap, the same of its exp_avg, exp_avg_sq and
    slow weights after it (`leaf_diffs`: both sides took the same inputs).
    On its own: change_gap, the worst leaf's gap of norms of the parameters'
    change over all the steps, and state_gap, the same of the optimizer's
    state after them. The state goes kind by kind (exp_avg, exp_avg_sq,
    slow), each against its own median leaf, and reads infinite where the
    program kept none. Leaves whose reference gradient at the first step is
    under a thousandth of the median leaf's are left out."""
    (history, records, poses), (ref_history, ref_records, ref_poses) = got, ref
    keep = moving_leaves(ref_records[0]["grad"])
    per_step = [leaf_gaps(r["grad"], rr["grad"], keep) for r, rr in zip(records, ref_records)]
    stack = [torch.cat([p["init_pose"][None], p["pose"]]) for p in poses]
    ref_stack = [torch.cat([p["init_pose"][None], p["pose"]]) for p in ref_poses]
    pose = [pose_gaps(a, b["scale"], c, d["scale"])
            for a, b, c, d in zip(stack, poses, ref_stack, ref_poses)]
    out = {"loss_gap": loss_gap(history, ref_history),
           "grad_gap": max(statistics.median(g) for g in per_step),
           "grad_gap_worst_leaf": max(max(g) for g in per_step),
           "grad_gap_first": max(per_step[0]),
           **{k: max(g[k] for g in pose) for k in pose[0]}}
    def kind(r, j):
        return {n: r["state"][n][j + 1] for n in keep}

    if follows:
        out["update_gap"] = max(max(leaf_diffs({n: r["after"][n] - r["before"][n] for n in keep},
                                               {n: rr["after"][n] - rr["before"][n] for n in keep},
                                               keep))
                                for r, rr in zip(records, ref_records))
        out["state_gap"] = max(max(leaf_diffs(kind(r, j), kind(rr, j), keep))
                               if r["state"] else math.inf
                               for r, rr in zip(records, ref_records) for j in range(len(STATE)))
    else:
        first, last, ref_last = records[0]["before"], records[-1], ref_records[-1]
        out["change_gap"] = max(leaf_gaps({n: last["after"][n] - first[n] for n in keep},
                                          {n: ref_last["after"][n] - first[n] for n in keep},
                                          keep))
        out["state_gap"] = max(max(leaf_gaps(kind(last, j), kind(ref_last, j), keep))
                               if last["state"] else math.inf for j in range(len(STATE)))
    out["leaves_kept"] = float(len(keep))
    return out
