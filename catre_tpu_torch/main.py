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
  python -m catre_tpu_torch.main --config-file ... --num-chips 4
  python -m catre_tpu_torch.main --config-file ... --num-chips 8 --num-machines 2 \\
      --machine-rank 0 --dist-url tcp://<machine 0's address>:<port>

Without --eval-only the config trains (`engine/runner.py::do_train`):
OUTPUT_DIR gets log.txt, config_dump.py, metrics.json, tb/ and ckpt/step_*.pt;
--resume goes on after the latest of those checkpoints. MODEL.WEIGHTS is a
reference checkpoint (.pth / .pkl) or a directory of the port's checkpoints
(`tools/convert_checkpoint.py` writes one from a .pth).

--num-chips N starts N processes on this machine, one per card (0: every
card; with --device cpu, N processes on the CPU), and --num-machines /
--machine-rank / --dist-url join the machines' processes into one group of
machines x N (`parallel/launch.py`; on one machine the address is a free
local port). Each process trains or tests data-parallel (`engine/runner.py`);
rank 0 writes log.txt, the others log.rank<r>.txt. The backend is gloo on
the CPU and NCCL with a card per process. At world 1 everything runs in this
process and `main` returns what `do_train` / `do_test` return; above, None.
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
                   help="processes on this machine, one per card (0 = every card; with "
                        "--device cpu, processes on the CPU)")
    p.add_argument("--num-machines", type=int, default=1, help="machines of the job")
    p.add_argument("--machine-rank", type=int, default=0, help="this machine's rank")
    p.add_argument("--dist-url", default="",
                   help="address of the process group, tcp://<machine 0>:<port> (on one "
                        "machine: a free local port)")
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
    when empty; logging to OUTPUT_DIR/log.txt (log.rank<r>.txt on rank r >
    0); the seed (SEED < 0: from the clock, rank 0's on every process,
    written back); OUTPUT_DIR/config_dump.py from rank 0. -> the config."""
    from .config.build import validate_config
    from .config.loader import apply_overrides, dump_config, load_config
    from .parallel import comm

    cfg = load_config(args.config_file)
    cfg = apply_overrides(cfg, [o for o in args.opts if "=" in o])
    validate_config(cfg)
    if not cfg.get("OUTPUT_DIR"):
        base = osp.splitext(osp.basename(args.config_file))[0]
        cfg["OUTPUT_DIR"] = osp.join(cfg.get("OUTPUT_ROOT", "output"), "catre_tpu_torch", base)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    rank = comm.get_rank()
    _log_to(osp.join(cfg.OUTPUT_DIR, "log.txt" if rank == 0 else f"log.rank{rank}.txt"))
    if comm.is_dist_avail_and_initialized() and rank == 0:
        logger.info("a process group of %d, backend %s", comm.get_world_size(),
                    torch.distributed.get_backend())
    if cfg.get("DEBUG", False):
        # DEBUG mode (`main_catre.py:104-109`): tighter feedback loops
        cfg["TRAIN"]["PRINT_FREQ"] = 1
        cfg["DATALOADER"]["NUM_WORKERS"] = 0
    seed = int(cfg.get("SEED", -1))
    if seed < 0:
        # every process shuffles and draws from one seed (the reference's shared_random_seed)
        seed = comm.all_gather(int(time.time()) % (2 ** 31))[0]
        cfg["SEED"] = seed
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    if rank == 0:
        dump_config(cfg, osp.join(cfg.OUTPUT_DIR, "config_dump.py"))
    return cfg


def run(device: str, args):
    """One process's run: the config, then `do_test` (--eval-only) or
    `do_train` on `device`."""
    cfg = setup(args)
    from .engine.runner import do_test, do_train

    cfg["NUM_CHIPS"] = int(args.num_chips)
    if args.eval_only:
        return do_test(cfg, device=device)
    return do_train(cfg, resume=args.resume, device=device)


def main(args=None):
    args = my_default_argument_parser().parse_args(args)
    if not 0 <= args.machine_rank < args.num_machines:
        raise ValueError(f"--machine-rank {args.machine_rank} outside --num-machines "
                         f"{args.num_machines}")
    if args.num_chips == 1 and args.num_machines == 1:
        return run(args.device, args)        # one process, no group
    from .parallel.launch import launch, local_devices

    return launch(run, (args,), local_devices(args.num_chips, args.device),
                  num_machines=args.num_machines, machine_rank=args.machine_rank,
                  dist_url=args.dist_url)


if __name__ == "__main__":
    main()
