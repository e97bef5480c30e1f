"""Convert a reference checkpoint (.pth, or a detectron2 / Caffe2 .pkl) into a
directory of the port's checkpoints, which `MODEL.WEIGHTS=<dir>` reads.

Counterpart of `catre_tpu/tools/convert_checkpoint.py`, which writes an orbax
directory. The model's shapes come from a config (default the shipped
`..._120e_tpu.py`); a checkpoint whose shapes differ raises.

  python -m catre_tpu_torch.tools.convert_checkpoint model_final.pth out_dir/
"""

from __future__ import annotations

import argparse

from ..config.build import FLAGSHIP_CONFIG, model_config_from
from ..config.loader import load_config
from ..models.catre import init_model
from ..utils.checkpoint import load_reference_checkpoint, save_checkpoint


def main(argv=None):
    parser = argparse.ArgumentParser(description="reference .pth -> a checkpoint of the port")
    parser.add_argument("torch_ckpt")
    parser.add_argument("out_dir")
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--config-file", default=str(FLAGSHIP_CONFIG),
                        help="the config whose model the checkpoint fills")
    args = parser.parse_args(argv)
    model = init_model(model_config_from(load_config(args.config_file)), seed=0)
    path = save_checkpoint(args.out_dir, args.step,
                           {"model": load_reference_checkpoint(args.torch_ckpt, model)})
    print(f"converted {args.torch_ckpt} -> {path} (step {args.step})")
    return 0


if __name__ == "__main__":
    main()
