"""Sampler-randomness parity-tolerance study (SURVEY section 7.3 #2).

The real-checkpoint parity budget against the reference is 0.5 mAP points,
and the point sampling is random on both sides: the port draws the ball-crop
candidates from its positional draws (`data/loader.py::counter_draws`), the
reference from torch's generator (`core/utils/cat_data_utils.py:289-320`
`crop_ball_from_pts`, called by its test path through
`crop_ball_from_depth_image:380` with centre t_est and radius ratio *
||R_est @ scale_est||). So the metrics carry a term of the sampler; this tool
measures it on a fixed synthetic split with FIXED init estimates on disk (the
sampling seed is the only input that varies):

  arm A (the port): N evaluations (loader -> refine -> NOCS mAP), only
      `CATRELoader(seed=...)` varying; at test it feeds only the ball-crop
      draws (est init, no depth augmentation).
  arm B (reference): M runs in which every instance's cloud is sampled on the
      host by the reference's own `crop_ball_from_pts`, imported from
      `--ref-root`, over the same candidates (mask and depth > 0 pixels of the
      same back-projected cloud, the same centre and radius), through the
      same refine and evaluator.

Report (JSON and markdown): per metric mean +- sigma per arm, |dmean|
between the arms, and the iteration-0 invariance (the init estimates do not
depend on the seed, so the iteration-0 table is the same in every run). The
claim holds when sigma and |dmean| are both << 0.5 points.

    python -m catre_tpu_torch.tools.sampler_spread --out DIR [--data-root DIR]
        [--frames 160] [--seeds 8] [--ref-seeds 4] [--ckpt PATH]
        [--n-iters 4] [--device cuda|cpu]

DTYPE study (`--dtype-arms f32,bf16_fused,bf16_unfused`): the bf16 term of
the same budget. The arms share the loader seeds, so their clouds are the
same and the per-seed deltas isolate the compute dtype and the kernels; the
report adds |dmean| and the largest per-seed |delta| of each arm against the
first. Arm B is not run in this mode.

Counterpart of `catre_tpu/tools/sampler_spread.py` on the port's loader,
refine (`engine/refiner.py`) and evaluator. `--platform cpu|tpu` became
`--device` (the card unless `--device cpu`): on the card the study runs the
shipped bf16 refine with K1-K3, on the CPU the f32 plain refine, as the JAX
tool does on the TPU and the CPU. The arms map onto the port's model flags:
f32 (plain, f32), bf16_unfused (plain, bf16), bf16_fused (bf16, K1-K3).
`--ckpt` takes what `MODEL.WEIGHTS` takes (`utils/checkpoint.py::
load_weights`). Arm B needs the reference checkout: where `--ref-seeds` > 0
and `--ref-root` has no `core/utils/cat_data_utils.py`, the study raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from ..data import nocs
from ..data.loader import CATRELoader, LoaderConfig
from ..engine.refiner import make_refine_fn
from ..eval.evaluator import CATREEvaluator, run_inference
from ..geom.transforms import backproject
from ..models.catre import CATREConfig, init_model
from ..utils.checkpoint import load_weights
from .synth_nocs import generate_split

REF_SAMPLER = osp.join("core", "utils", "cat_data_utils.py")

# arm -> the model flags it runs under
ARM_SPECS = {
    "f32": {"dtype": None, "fused_heads": False},
    "bf16_unfused": {"dtype": torch.bfloat16, "fused_heads": False},
    "bf16_fused": {"dtype": torch.bfloat16, "fused_heads": True},
}


def _rodrigues(w):
    """Rotation matrix from a rotation vector."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3, dtype=np.float64)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64)
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def inject_fixed_init(dicts, rot_std_deg=5.0, trans_std=0.01, scale_std=0.01, seed=777):
    """Attach fixed `pose_est` / `scale_est` to every annotation (the shape of
    external detections, `data/nocs.py`'s merge path), so that the init is
    the same in every run whatever the loader's seed."""
    rng = np.random.default_rng(seed)
    for rec in dicts:
        for a in rec.get("annotations", []):
            R = np.asarray(a["pose"], np.float64)[:, :3]
            t = np.asarray(a["pose"], np.float64)[:, 3]
            w = rng.normal(0.0, np.deg2rad(rot_std_deg), 3)
            Rn = _rodrigues(w) @ R
            tn = t + rng.normal(0.0, trans_std, 3)
            a["pose_est"] = np.concatenate([Rn, tn[:, None]], axis=1).astype(np.float32)
            a["scale_est"] = (np.asarray(a["scale"], np.float64)
                              * (1.0 + rng.normal(0.0, scale_std, 3))).astype(np.float32)
            a.setdefault("bbox_est", a.get("bbox"))
            a.setdefault("score", 1.0)
    return dicts


def _make_ref_loader_cls(ref_root: str):
    """A `CATRELoader` whose sampling runs on the host through the reference's
    own `crop_ball_from_pts` (the same candidates, centre and radius; torch's
    generator in place of the port's draws)."""
    if not osp.isfile(osp.join(ref_root, REF_SAMPLER)):
        raise FileNotFoundError(f"arm B imports the reference's crop_ball_from_pts from "
                                f"{osp.join(ref_root, REF_SAMPLER)}, which is absent: pass "
                                "--ref-root <reference checkout> or --ref-seeds 0")
    sys.path.insert(0, ref_root)
    from core.utils.cat_data_utils import crop_ball_from_pts

    class RefSamplerLoader(CATRELoader):
        ref_run_seed = 0  # a torch stream of its own per arm-B run

        def _dispatch_group(self, items):
            return items  # host only: nothing to launch

        def _finalize_group(self, items):
            out = []
            for g, record, data in items:
                data["pcl"] = self._ref_sample(g, data)
                data["pcl_idx"] = None
                data["n_inside"] = None
                out.append(self._post_device(g, record, data))
            return out

        def _ref_sample(self, g, data):
            depth = np.asarray(data["depth_ship"])
            if depth.dtype == np.uint16:
                depth = depth.astype(np.float32) / 1000.0
            K = np.asarray(data["K"], np.float32)
            cloud = backproject(torch.from_numpy(depth), torch.from_numpy(K)).numpy()
            packed = np.asarray(data["masks_packed"])
            m, p = self.cfg.max_objs_per_image, self.cfg.num_pcl
            pose, scale = self._crop_args(data)
            pcl = np.zeros((m, p, 3), np.float32)
            for i in range(m):
                if not data["valid"][i]:
                    continue
                mask = (packed[i].astype(bool) if packed.ndim == 3
                        else ((packed >> packed.dtype.type(i)) & 1).astype(bool))
                pts = cloud[mask & (depth > 0)].astype(np.float32)
                if pts.shape[0] == 0:
                    continue
                pose_i = np.asarray(pose[i], np.float32)
                radius = float(self.cfg.depth_sample_ball_ratio
                               * np.linalg.norm(pose_i[:, :3] @ np.asarray(scale[i], np.float32)))
                torch.manual_seed(int(np.random.SeedSequence(
                    (self.ref_run_seed, g, i)).generate_state(1)[0]))
                idx = crop_ball_from_pts(torch.from_numpy(pts), torch.from_numpy(pose_i[:, 3]),
                                         radius, num_points=p)
                pcl[i] = pts[np.asarray(idx)]
            return pcl

    return RefSamplerLoader


def _stats(runs: list, last: int, keys: list, spread: bool = False) -> dict:
    out = {}
    for k in keys:
        v = np.array([r[last][k] for r in runs])
        s = {"mean": float(v.mean()), "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0}
        if spread:
            s.update(min=float(v.min()), max=float(v.max()))
        out[k] = s
    return out


def run_dtype_study(args, dicts, lcfg, base_cfg, weights, one_run):
    """The bf16 term of the 0.5-point budget: the same loader seeds in every
    arm, so the same clouds, and per-seed deltas of the compute dtype and the
    kernels."""
    arms = [a.strip() for a in args.dtype_arms.split(",") if a.strip()]
    for a in arms:
        if a not in ARM_SPECS:
            raise ValueError(f"unknown dtype arm {a!r} (choices: {list(ARM_SPECS)})")
    runs = {}
    for arm in arms:
        model = init_model(dataclasses.replace(base_cfg, **ARM_SPECS[arm]), device=args.device)
        model.load_state_dict(weights)
        refine = make_refine_fn(model, args.n_iters)
        runs[arm] = [one_run(CATRELoader(dicts, lcfg, phase="test",
                                         ims_per_batch=args.ims_per_batch, seed=s,
                                         num_workers=4, device=args.device),
                             f"{arm} seed={s}", refine)
                     for s in range(args.seeds)]

    last = args.n_iters
    keys = list(runs[arms[0]][0][last].keys())
    base = arms[0]
    report = {"mode": "dtype", "frames": args.frames, "seeds": args.seeds,
              "ckpt": args.ckpt or "random-init", "n_iters": args.n_iters,
              "arms": {a: _stats(runs[a], last, keys) for a in arms}}
    for arm in arms[1:]:
        deltas = {k: np.array([runs[arm][s][last][k] - runs[base][s][last][k]
                               for s in range(args.seeds)]) for k in keys}
        report[f"delta_{arm}_vs_{base}"] = {
            k: {"dmean": float(d.mean()), "abs_dmean": float(abs(d.mean())),
                "max_abs": float(np.abs(d).max())}
            for k, d in deltas.items()}

    os.makedirs(args.out, exist_ok=True)
    with open(osp.join(args.out, "dtype_spread.json"), "w") as f:
        json.dump(report, f, indent=1)
    hdr = "| metric | " + " | ".join(f"{a} mean±σ" for a in arms) + " | " + " | ".join(
        f"\\|Δ\\| {a} vs {base}" for a in arms[1:]) + " |"
    lines = [hdr, "|---|" + "---|" * (len(arms) + len(arms) - 1)]
    for k in keys:
        row = [k]
        for a in arms:
            s = report["arms"][a][k]
            row.append(f"{s['mean']:.2f} ± {s['std']:.3f}")
        for a in arms[1:]:
            d = report[f"delta_{a}_vs_{base}"][k]
            row.append(f"{d['abs_dmean']:.3f} (max {d['max_abs']:.3f})")
        lines.append("| " + " | ".join(row) + " |")
    md = "\n".join(lines)
    with open(osp.join(args.out, "dtype_spread.md"), "w") as f:
        f.write(md + "\n")
    print(md, flush=True)
    return report


def run_study(args):
    ref_cls = None
    if args.ref_seeds > 0 and not args.dtype_arms:
        ref_cls = _make_ref_loader_cls(args.ref_root)
    root = osp.join(args.data_root, "REAL")
    if not osp.exists(osp.join(root, "real_test_list_all.txt")):
        print(f"[spread] generating {args.frames} synthetic test frames ...", flush=True)
        generate_split(root, split="real_test", n_frames=args.frames, n_objs=6, seed=123)
    # the name must hold "real" and "test": NOCSDataset takes the split
    # ("real_test") and the REAL intrinsics from it; another name builds
    # the CAMERA "val" split and 0 records
    nocs.register_dataset("nocs_spread_real_test", image_root=root, use_cache=True)
    dicts = nocs.get_dataset_dicts("nocs_spread_real_test")
    if not dicts:
        raise RuntimeError(f"synthetic split under {root} built 0 records")
    inject_fixed_init(dicts)

    lcfg = LoaderConfig(num_pcl=args.num_pcl, max_objs_per_image=8, aug_depth=False,
                        cache_decoded="ram")
    on_card = torch.device(args.device).type == "cuda"
    base_cfg = CATREConfig(num_pcl=args.num_pcl,
                           **ARM_SPECS["bf16_fused" if on_card else "f32"])
    model = init_model(base_cfg, device=args.device)
    weights = load_weights(args.ckpt, model) if args.ckpt else model.state_dict()
    model.load_state_dict(weights)
    refine = make_refine_fn(model, args.n_iters)

    def one_run(loader, tag, refine_fn=None):
        ev = CATREEvaluator(dicts, n_iters=args.n_iters, output_dir=None)
        t0 = time.perf_counter()
        run_inference(refine_fn or refine, loader, ev, n_iters=args.n_iters, warmup=0,
                      compute_probe_every=0)
        res = ev.evaluate(dump=False)
        print(f"[spread] {tag}: {time.perf_counter() - t0:.1f}s", flush=True)
        return {i: r["summary"] for i, r in res.items()}

    if args.dtype_arms:
        return run_dtype_study(args, dicts, lcfg, base_cfg, weights, one_run)

    def loader(cls, s):
        return cls(dicts, lcfg, phase="test", ims_per_batch=args.ims_per_batch, seed=s,
                   num_workers=4, device=args.device)

    runs_a = [one_run(loader(CATRELoader, s), f"ours seed={s}") for s in range(args.seeds)]
    runs_b = []
    if ref_cls is not None:
        for s in range(args.ref_seeds):
            ld = loader(ref_cls, s)
            ld.ref_run_seed = 1000 + s
            runs_b.append(one_run(ld, f"reference seed={s}"))

    # ---- report
    last = args.n_iters
    keys = list(runs_a[0][last].keys())
    # iteration-0 invariance: the init is fixed on disk, so the iteration-0
    # metrics are the same in every run of both arms (sampling moves only the refine)
    iter0 = np.array([[r[0][k] for k in keys] for r in runs_a + runs_b])
    iter0_spread = float(np.ptp(iter0, axis=0).max())
    ta = _stats(runs_a, last, keys, spread=True)
    report = {
        "frames": args.frames, "seeds": args.seeds,
        "ref_seeds": args.ref_seeds, "ckpt": args.ckpt or "random-init",
        "n_iters": args.n_iters, "iter0_max_ptp": iter0_spread,
        # iteration 0 scores the fixed inits (about 5 deg, 1 cm, 1% off gt): a
        # sound scoring path shows high values here, where all zeros with ptp 0
        # would mean broken scoring
        "iter0": dict(runs_a[0][0]),
        "ours": ta,
    }
    if runs_b:
        tb = _stats(runs_b, last, keys, spread=True)
        report["reference"] = tb
        report["abs_dmean"] = {k: abs(ta[k]["mean"] - tb[k]["mean"]) for k in keys}
    os.makedirs(args.out, exist_ok=True)
    with open(osp.join(args.out, "sampler_spread.json"), "w") as f:
        json.dump(report, f, indent=1)

    lines = ["| metric | ours mean±σ (N=%d) | ref mean±σ (N=%d) | \\|Δmean\\| |"
             % (args.seeds, args.ref_seeds), "|---|---|---|---|"]
    for k in keys:
        a = ta[k]
        if runs_b:
            b, d = report["reference"][k], report["abs_dmean"][k]
            lines.append(f"| {k} | {a['mean']:.2f} ± {a['std']:.3f} | "
                         f"{b['mean']:.2f} ± {b['std']:.3f} | {d:.3f} |")
        else:
            lines.append(f"| {k} | {a['mean']:.2f} ± {a['std']:.3f} | — | — |")
    md = "\n".join(lines)
    with open(osp.join(args.out, "sampler_spread.md"), "w") as f:
        f.write(md + "\n")
    print(md, flush=True)
    print("[spread] iter-0 (fixed init):",
          {k: round(v, 2) for k, v in report["iter0"].items()}, flush=True)
    print(f"[spread] iter-0 invariance max ptp = {iter0_spread:g} (must be 0)", flush=True)
    return report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--ref-seeds", type=int, default=4)
    p.add_argument("--ref-root", default="/root/reference",
                   help="the reference checkout that arm B imports its sampler from")
    p.add_argument("--ckpt", default="")
    p.add_argument("--n-iters", type=int, default=4)
    p.add_argument("--ims-per-batch", type=int, default=16)
    p.add_argument("--num-pcl", type=int, default=1024,
                   help="cloud size (production 1024; small for smokes)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype-arms", default="", help=(
        "comma list of f32,bf16_unfused,bf16_fused: the dtype study (the same seeds in "
        "every arm; per-metric deltas against the first)"))
    args = p.parse_args(argv)
    if not args.data_root:
        args.data_root = osp.join(args.out, "data")
    return args


def main(argv=None) -> int:
    run_study(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
