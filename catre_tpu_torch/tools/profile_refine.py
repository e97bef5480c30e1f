"""Where the time of one flagship refine call goes, on one CUDA card.

    python -m catre_tpu_torch.tools.profile_refine [--batch 2048] [--fused-encoder]
                                                   [--block-size G]

Builds the flagship refine (`entry.entry`: bf16, 1024 + 1024 points, 4
iterations; `--fused-encoder` runs the encoder columns through K9,
`--block-size G` the rot head through K8 with G objects per block), takes
one warm-up call, then one call under `torch.profiler`. Prints the card's
name and power limit, the call's wall time, the summed device time of its
kernels and the idle share (1 - device / wall), and the kernels ranked by
device time with their launches and share. A second profiled call records
input shapes and lists the library matrix products by shape, so that one
can see which products did not go through a kernel of this package.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..entry import entry
from ..ops import launch_counts, reset_launch_counts
from .profile_train import device_us, card_line, device_kernels, print_kernels, print_products


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--fused-encoder", action="store_true")
    ap.add_argument("--block-size", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_refine needs a CUDA card")
    overrides = {"fused_encoder": args.fused_encoder, "fused_block_size": args.block_size}
    refine, inputs = entry("cuda", batch_size=args.batch, seed=0, **overrides)
    refine(*inputs)                                                  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        refine(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = device_kernels(prof.key_averages())
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f"card: {card_line()}")
    print(f"B={args.batch} {overrides}, launches in the call "
          f"{ {k: v for k, v in launch_counts().items() if v} }")
    print(f"B={args.batch} one refine call: wall {wall_ms:.3f} ms, device kernels "
          f"{device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.4f}")
    print_kernels(kernels, args.top)
    with profile(activities=activities, record_shapes=True) as prof:
        refine(*inputs)
        torch.cuda.synchronize()
    print_products(prof, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
