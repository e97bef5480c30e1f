"""Convert a reference checkpoint (.pth, or a detectron2 / Caffe2 .pkl) or an
orbax checkpoint directory of the JAX package into a directory of the port's
checkpoints, which `MODEL.WEIGHTS=<dir>` reads.

Counterpart of `catre_tpu/tools/convert_checkpoint.py`, which writes an orbax
directory; the port writes its own format and reads orbax only here and in
`engine/runner.py::build_model`, where tensorstore is installed. So a model
trained with the JAX package is converted on a host that has tensorstore and
scored on one that has a card. The model's shapes come from a config (default
the shipped `..._120e_tpu.py`); a checkpoint whose shapes differ raises.

  python -m catre_tpu_torch.tools.convert_checkpoint model_final.pth out_dir/
  python -m catre_tpu_torch.tools.convert_checkpoint jax_run/ckpt out_dir/ [--step 775]

`--step` is the step written for a .pth / .pkl (default 0); for an orbax
directory it is the step read (default its latest), written under the same
number.
"""

from __future__ import annotations

import argparse

from ..config.build import FLAGSHIP_CONFIG, model_config_from
from ..config.loader import load_config
from ..models.catre import init_model
from ..utils.checkpoint import (is_orbax_dir, load_orbax_checkpoint, load_reference_checkpoint,
                                orbax_steps, save_checkpoint)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="reference .pth or JAX orbax directory -> a checkpoint of the port")
    parser.add_argument("torch_ckpt", help="a .pth / .pkl, or an orbax checkpoint directory")
    parser.add_argument("out_dir")
    parser.add_argument("--step", type=int, default=None,
                        help="the step written (.pth / .pkl, default 0) or read (orbax, "
                        "default the latest)")
    parser.add_argument("--config-file", default=str(FLAGSHIP_CONFIG),
                        help="the config whose model the checkpoint fills")
    args = parser.parse_args(argv)
    model = init_model(model_config_from(load_config(args.config_file)), seed=0)
    if is_orbax_dir(args.torch_ckpt):
        step = orbax_steps(args.torch_ckpt)[-1] if args.step is None else args.step
        sd = load_orbax_checkpoint(args.torch_ckpt, model, step)
    else:
        step = 0 if args.step is None else args.step
        sd = load_reference_checkpoint(args.torch_ckpt, model)
    path = save_checkpoint(args.out_dir, step, {"model": sd})
    print(f"converted {args.torch_ckpt} -> {path} (step {step})")
    return 0


if __name__ == "__main__":
    main()
