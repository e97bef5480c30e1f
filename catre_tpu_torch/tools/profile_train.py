"""Where the time of one flagship training step goes, on one CUDA card.

    python -m catre_tpu_torch.tools.profile_train [--batch 512] [--trace PATH]

Builds the flagship trainer (`entry.flagship_trainer`: bf16, K3 forward and
K4 backward in the rotation head, plain encoder), takes one warm-up step,
then one step under `torch.profiler` (CPU and CUDA activities). Prints the
card's name and power limit, the step's wall time, the summed device time of
its kernels and the idle share (1 - device / wall), the host time and GPU
span of each train-step range (train.forward, train.backward,
train.optimizer), and the kernels ranked by device time with their
launches and share. `--trace`
writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..entry import flagship_trainer


def _device_us(evt, total: bool = False) -> float:
    """Device time in us (self, or including children), across torch versions."""
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return getattr(evt, name, None) or getattr(evt, old, 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    t = flagship_trainer("cuda", batch_size=args.batch, seed=0)
    t.state, _ = t.step(t.state, t.batch, t.generator, t.lr)        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        t.state, _ = t.step(t.state, t.batch, t.generator, t.lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"card: {card}")
    print(f"B={args.batch} one train step: wall {wall_ms:.3f} ms, device kernels "
          f"{device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.4f}")
    # a range's GPU span (kernels launched from the main thread inside it);
    # the backward's kernels are launched by autograd's device thread, so
    # its span is empty and its time is what the kernel table leaves over
    for e in events:
        if e.key.startswith(("train.", "Optimizer.step")):
            side = "device span" if e.device_type == DeviceType.CUDA else "host"
            ms = (_device_us(e) if e.device_type == DeviceType.CUDA else e.cpu_time_total) / 1e3
            print(f"range {e.key}: calls {e.count}, {side} {ms:.3f} ms")
    print(f"{'device ms':>10} {'launches':>8} {'share':>6}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        ms = _device_us(e) / 1e3
        print(f"{ms:10.3f} {e.count:8d} {ms / device_ms:6.1%}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
