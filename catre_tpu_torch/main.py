"""Command line of the port: train a config, or evaluate it from a checkpoint.

Counterpart of `catre_tpu/main.py`: `my_default_argument_parser` (:22),
`setup` (:47) and `main` (:104), with `--device` (default cuda). Behavioural
reference: `core/catre/main_catre.py:44-193` (config load and merge, the
OUTPUT_DIR from the config's name, the seed, the config dump, the train /
test dispatch).

  python -m catre_tpu_torch.main --config-file catre_tpu/configs/nocs_real/...py
  python -m catre_tpu_torch.main --config-file ... --resume OUTPUT_DIR=<the run's directory>
  python -m catre_tpu_torch.main --config-file ... \\
      --eval-only MODEL.WEIGHTS=model_final.pth
  python -m catre_tpu_torch.main ... --eval-only --device cpu MODEL.WEIGHTS=ckpt_dir/

Without --eval-only the config trains (`engine/runner.py::do_train`):
OUTPUT_DIR gets log.txt, config_dump.py, metrics.json, tb/ and ckpt/step_*.pt;
--resume goes on after the latest of those checkpoints. MODEL.WEIGHTS is a
reference checkpoint (.pth / .pkl) or a directory of the port's checkpoints
(`tools/convert_checkpoint.py` writes one from a .pth). A multi-process
launch (--num-machines > 1, --dist-url) or --num-chips above 1 is ROADMAP
item 14 and raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import random
import sys
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)
_HANDLERS: list = []     # the handlers `setup` put on the root logger


def my_default_argument_parser():
    """The reference's options (`core/utils/default_args_setup.py:20-97`),
    with --device."""
    p = argparse.ArgumentParser(description="catre_tpu_torch")
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-chips", type=int, default=1,
                   help="devices to train or evaluate on (the port runs on one; 0 = all, "
                        "or above 1, is ROADMAP item 14)")
    p.add_argument("--num-machines", type=int, default=1,
                   help="processes of a multi-process job (ROADMAP item 14 beyond 1)")
    p.add_argument("--machine-rank", type=int, default=0, help="this process's rank")
    p.add_argument("--dist-url", default="",
                   help="address of the process group (ROADMAP item 14)")
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="accepted for the reference's command lines; no effect")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="dotted config overrides KEY.SUBKEY=value")
    return p


def _log_to(path: str) -> None:
    """Log INFO and above to `path` (and to stdout unless a stream handler is
    already in place), replacing what an earlier `setup` added."""
    root = logging.getLogger()
    for h in _HANDLERS:
        root.removeHandler(h)
        h.close()
    _HANDLERS.clear()
    handlers = [logging.FileHandler(path)]
    if not any(type(h) is logging.StreamHandler for h in root.handlers):
        handlers.append(logging.StreamHandler(sys.stdout))
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
        _HANDLERS.append(h)
    root.setLevel(logging.INFO)


def setup(args):
    """Config file + overrides, validated; OUTPUT_DIR from the config's name
    when empty; logging to OUTPUT_DIR/log.txt; the seed (SEED < 0: from the
    clock, written back); OUTPUT_DIR/config_dump.py. -> the config."""
    from .config.build import validate_config
    from .config.loader import apply_overrides, dump_config, load_config

    cfg = load_config(args.config_file)
    cfg = apply_overrides(cfg, [o for o in args.opts if "=" in o])
    validate_config(cfg)
    if not cfg.get("OUTPUT_DIR"):
        base = osp.splitext(osp.basename(args.config_file))[0]
        cfg["OUTPUT_DIR"] = osp.join(cfg.get("OUTPUT_ROOT", "output"), "catre_tpu_torch", base)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    _log_to(osp.join(cfg.OUTPUT_DIR, "log.txt"))
    if cfg.get("DEBUG", False):
        # DEBUG mode (`main_catre.py:104-109`): tighter feedback loops
        cfg["TRAIN"]["PRINT_FREQ"] = 1
        cfg["DATALOADER"]["NUM_WORKERS"] = 0
    seed = int(cfg.get("SEED", -1))
    if seed < 0:
        seed = int(time.time()) % (2 ** 31)
        cfg["SEED"] = seed
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    dump_config(cfg, osp.join(cfg.OUTPUT_DIR, "config_dump.py"))
    return cfg


def main(args=None):
    args = my_default_argument_parser().parse_args(args)
    if args.num_machines > 1 or args.dist_url:
        raise NotImplementedError("a multi-process launch (--num-machines > 1, --dist-url) is "
                                  "not ported: ROADMAP item 14")
    cfg = setup(args)
    from .engine.runner import do_test, do_train

    cfg["NUM_CHIPS"] = int(args.num_chips)
    if args.eval_only:
        return do_test(cfg, device=args.device)
    return do_train(cfg, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
