"""Flagship-scale training soak driver (docs/TRAINRUN.md).

Runs the production `_tpu` recipe shape -- 1024-point clouds and 1024-point
mean-shape keypoints, B >= 512 flattened instances, 4 inner optimizer steps
a batch, the fused kernels (K3-K6 every iteration, K1-K3 in its evaluations on
the card), Ranger with flat_and_anneal -- against synthetic REAL275-shaped
data on disk, through the production path: the dataset registry ->
`CATRELoader` -> `engine/runner.py::do_train` (TRAIN2 mixing, periodic
evaluation and checkpoints, resume).

    python -m catre_tpu_torch.tools.soak --data-root DIR --out DIR \\
        [--epochs N] [--frames 2000] [--resume] [--device cpu] [--opts K=V ...]

Counterpart of `catre_tpu/tools/soak.py`: the same flags (and `--device`),
the same three splits written by `tools/synth_nocs.py` and the same override
list. The asset pickles (mean shapes, abs scales) are read under
CATRE_DATA_ROOT when it is set, else under `--data-root` (its
NOCS/obj_models/). Mirrors the reference's 120-epoch recipe driver
(`core/catre/engine/engine.py:164-424`); the kill + resume proof rests on
the loader's positional draws.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import sys

from ..config.build import FLAGSHIP_CONFIG
from ..config.loader import apply_overrides, load_config
from ..data import meta, nocs
from ..engine import runner
from .synth_nocs import generate_split

# the soak's recipe on top of the shipped config (`catre_tpu/tools/soak.py:87-102`)
OVERRIDES = [
    "SOLVER.CHECKPOINT_PERIOD=25",       # epochs (~775 iters at 2000/64)
    "SOLVER.MAX_TO_KEEP=5",
    "SOLVER.ANNEAL_POINT=0.72",
    "DATASETS.TRAIN2=('nocs_train_cmra',)",
    "DATASETS.TRAIN2_RATIO=0.25",
    "DATALOADER.CACHE_DECODED='device'",
    "DATALOADER.NUM_WORKERS=8",
    "INPUT.INIT_POSE_TYPE_TEST='gt_noise'",
    "MODEL.LOAD_POSES_TEST=False",
    "TEST.EVAL_PERIOD=3000",             # iters: a few evals per soak
    "TEST.IMS_PER_BATCH=32",
    "TRAIN.PRINT_FREQ=50",
    "SEED=11",
]


def ensure_data(data_root: str, frames: int, frames2: int, frames_test: int) -> None:
    """Write the three synthetic splits once (each checked by its list
    file)."""
    specs = [
        ("real", "real_train", frames, 0),
        ("cmra", "train", frames2, 1),       # CAMERA-shaped TRAIN2 stream
        ("real", "real_test", frames_test, 2),
    ]
    for sub, split, n, seed in specs:
        root = osp.join(data_root, sub.upper())
        if osp.exists(osp.join(root, f"{split}_list_all.txt")):
            continue
        print(f"[soak] generating {n} frames for {sub}/{split} ...", flush=True)
        generate_split(root, split=split, n_frames=n, n_objs=6, seed=seed)


def register(data_root: str) -> None:
    for name, sub in (("nocs_train_real", "REAL"), ("nocs_train_cmra", "CMRA"),
                      ("nocs_test_real", "REAL")):
        nocs.register_dataset(name, image_root=osp.join(data_root, sub), use_cache=True)


def soak_config(args):
    """The shipped config with the soak's overrides, then `--opts`."""
    cfg = load_config(str(FLAGSHIP_CONFIG))
    apply_overrides(cfg, [f"SOLVER.TOTAL_EPOCHS={args.epochs}"] + OVERRIDES + list(args.opts))
    cfg["OUTPUT_DIR"] = args.out
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--frames2", type=int, default=600)
    p.add_argument("--frames-test", type=int, default=192)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--opts", nargs="*", default=[])
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    if "CATRE_DATA_ROOT" not in os.environ:
        meta.set_data_root(args.data_root)
    ensure_data(args.data_root, args.frames, args.frames2, args.frames_test)
    register(args.data_root)
    runner.do_train(soak_config(args), resume=args.resume, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
