"""Where the time of one flagship training step goes, on one CUDA card.

    python -m catre_tpu_torch.tools.profile_train [--batch 512] [--plain-encoder]
        [--solver-config] [--frames N] [--trace PATH]

Builds the flagship trainer (`entry.flagship_trainer`: bf16, K3 forward and
K4 backward in the rotation head, K5/K6 encoder tails; `--plain-encoder`
turns FUSED_ENCODER_TRAIN off), takes one warm-up step, two steps timed by
the host clock (ms a step and the peak device memory of the two), then one
step under `torch.profiler` (CPU and CUDA activities). Prints the
card's name and power limit, the step's wall time, the summed device time of
its kernels and the idle share (1 - device / wall), the host time and GPU
span of each train-step range (train.forward, train.backward,
train.optimizer), and the kernels ranked by device time with their
launches and share. A second profiled step records input shapes and lists
the library matrix products (`aten::mm`, `addmm`, `bmm`, `baddbmm`) by
shape, so that one can see which products did not go through a kernel of
this package: with K5/K6 on, none has a tail's shape (128 -> 1024,
128 -> 512 or 512 -> 1024 over all N x P point rows). With K5/K6 on it also
splits each training tail's backward in the first profiled step by its
kernels, read off the timeline (K5: gate pass, two `sum_rows`, routing pass,
dx pass; K6: routing pass, cloud, dW3 and dW4 passes, four `sum_rows`), and
counts the copy kernels right after each: none, since both write dx in x's
dtype.
`--solver-config` trains under `entry.solver_example_config()` (clipping,
LR_MULT, FREEZE, three init modes: `chip_smoke.py` phase 7b's config) in
place of the shipped config. `--frames N` trains from a split on disk
instead of the synthetic batch: N frames of 480 x 640
(`entry.write_example_split`, seed 0) in a temporary directory, read by the
shipped train loader (`entry.shipped_train_loader`: 64 frames a step, B =
512, device cache, depth augmentation on the card; a seeded mean-shape
table) through `entry.train_from_split`; it prints the split's writing and
the loader's cold seconds, and the train.loader range (the next group's
draws and sampler, the batch's upload) beside the step's. `--batch` is then
the loader's (64 frames x 8 slots). `--trace` writes the Chrome trace of
the first profiled step.
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..entry import (flagship_trainer, shipped_train_loader, solver_example_config,
                     train_from_split, write_example_split)
from ..ops import launch_counts, reset_launch_counts

UNPROFILED_STEPS = 2      # timed by the host clock before the profiled step


def device_us(evt, total: bool = False) -> float:
    """Device time in us (self, or including children), across torch versions."""
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return getattr(evt, name, None) or getattr(evt, old, 0.0)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def device_kernels(events) -> list:
    """The profiled device kernels (no user ranges) of `prof.key_averages()`."""
    return [e for e in events if e.device_type == DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def print_kernels(kernels, top: int) -> None:
    """Kernels ranked by device time, with launches and share."""
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f"{'device ms':>10} {'launches':>8} {'share':>6}  kernel")
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        ms = device_us(e) / 1e3
        print(f"{ms:10.3f} {e.count:8d} {ms / device_ms:6.1%}  {e.key[:110]}")


def print_products(prof, top: int) -> None:
    """Library matrix products of a profile taken with `record_shapes`, by input shape."""
    products = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")]
    print(f"library matrix products by input shape: {sum(e.count for e in products)} calls, "
          f"{sum(device_us(e) for e in products) / 1e3:.3f} ms")
    for e in sorted(products, key=device_us, reverse=True)[:top]:
        print(f"{device_us(e) / 1e3:10.3f} {e.count:8d}  {e.key} {e.input_shapes}")


# each training tail's backward as its kernels follow each other on the timeline
# (substrings of the kernel names): K5 bf16 (csrc/encoder_stn_tail_bwd.cuh) and K6
# bf16 (csrc/encoder_tail_bwd_wgmma.cuh), each with its sum_rows launches
TAIL_BACKWARDS = {
    "K5 backward": ("gate_pass", "sum_rows", "sum_rows", "route_clouds", "dx_pass"),
    "K6 backward": ("route_clouds", "cloud_pass", "dw3_pass", "dw4_pass", "sum_rows", "sum_rows",
                    "sum_rows", "sum_rows"),
}


def print_tail_backwards(prof) -> None:
    """Each training tail's backward in the step's timeline: its launches,
    device ms by kernel summed over the step, and the kernel right after its
    last one, which must not be a copy (the dx cast the backwards no longer
    need: both write dx in x's dtype)."""
    timeline = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
    for tail, names in TAIL_BACKWARDS.items():
        parts = [0.0] * len(names)
        launches, copies, copy_us = 0, 0, 0.0
        for i in range(len(timeline) - len(names) + 1):
            run = timeline[i:i + len(names)]
            if not all(n in e.name for n, e in zip(names, run)):
                continue
            launches += 1
            for j, e in enumerate(run):
                parts[j] += e.time_range.elapsed_us()
            after = timeline[i + len(names)] if i + len(names) < len(timeline) else None
            if after is not None and "copy" in after.name.lower():
                copies += 1
                copy_us += after.time_range.elapsed_us()
        split = ", ".join(f"{n} {v / 1e3:.3f}" for n, v in zip(names, parts))
        print(f"{tail}, {launches} launches in the step, device ms: {split}; total "
              f"{sum(parts) / 1e3:.3f}; copy kernels right after it: {copies} ({copy_us / 1e3:.3f} ms)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", default="")
    ap.add_argument("--plain-encoder", action="store_true",
                    help="train the encoder as plain layers under autograd")
    ap.add_argument("--solver-config", action="store_true",
                    help="train under phase 7b's solver config instead of the shipped one")
    ap.add_argument("--frames", type=int, default=0,
                    help="train from a written split of this many 480 x 640 frames")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = card_line()
    if args.frames:
        return profile_from_disk(args, card)
    overrides = {"fused_encoder_train": False} if args.plain_encoder else {}
    cfg = solver_example_config() if args.solver_config else None
    t = flagship_trainer("cuda", batch_size=args.batch, seed=0, cfg=cfg, **overrides)
    t.state, _ = t.step(t.state, t.batch, t.generator, t.lr)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    for _ in range(UNPROFILED_STEPS):
        t.state, _ = t.step(t.state, t.batch, t.generator, t.lr)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / UNPROFILED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        t.state, _ = t.step(t.state, t.batch, t.generator, t.lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    events = prof.key_averages()
    kernels = device_kernels(events)
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f"card: {card}")
    print(f"B={args.batch} {'plain' if args.plain_encoder else 'K5/K6'} encoder tails, "
          f"{'solver' if args.solver_config else 'shipped'} config, "
          f"launches in the step {launch_counts()}")
    print(f"B={args.batch} {UNPROFILED_STEPS} steps without the profiler: {step_ms:.3f} ms a step "
          f"(host clock), peak memory {peak:.2f} GiB")
    print(f"B={args.batch} one train step: wall {wall_ms:.3f} ms, device kernels "
          f"{device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.4f}")
    # a range's GPU span (kernels launched from the main thread inside it);
    # the backward's kernels are launched by autograd's device thread, so
    # its span is empty and its time is what the kernel table leaves over
    for e in events:
        if e.key.startswith(("train.", "Optimizer.step")):
            side = "device span" if e.device_type == DeviceType.CUDA else "host"
            ms = (device_us(e) if e.device_type == DeviceType.CUDA else e.cpu_time_total) / 1e3
            print(f"range {e.key}: calls {e.count}, {side} {ms:.3f} ms")
    print_kernels(kernels, args.top)
    if not args.plain_encoder:
        print_tail_backwards(prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t.state, _ = t.step(t.state, t.batch, t.generator, t.lr)
        torch.cuda.synchronize()
    print_products(prof, args.top)
    return 0


def profile_from_disk(args, card: str) -> int:
    """`--frames N`: one warm-up step, UNPROFILED_STEPS timed, one profiled,
    each on the loader's next group."""
    import numpy as np

    marks = {}

    def on_step(i, metrics):
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks["t0"] = time.perf_counter()
        elif i == UNPROFILED_STEPS:
            torch.cuda.synchronize()
            marks["step_ms"] = (time.perf_counter() - marks["t0"]) * 1e3 / UNPROFILED_STEPS
            marks["peak"] = torch.cuda.max_memory_allocated() / 2**30
            reset_launch_counts()
            prof.start()
            marks["t1"] = time.perf_counter()
        elif i == UNPROFILED_STEPS + 1:
            torch.cuda.synchronize()
            marks["wall_ms"] = (time.perf_counter() - marks["t1"]) * 1e3
            prof.stop()

    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with tempfile.TemporaryDirectory(prefix="catre_train_split_") as root:
        t0 = time.perf_counter()
        records = write_example_split(root, args.frames)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loader = shipped_train_loader(records, "cuda", mean_points=table)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        train_from_split(records, UNPROFILED_STEPS + 2, "cuda", callback=on_step, loader=loader)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    events = prof.key_averages()
    kernels = device_kernels(events)
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    b = loader.ims_per_batch * loader.cfg.max_objs_per_image
    print(f"card: {card}")
    print(f"{args.frames} frames 480x640 written in {write_s:.1f} s; loader cold (decode in "
          f"{loader.num_workers} threads + device cache {loader.device_cache_gb():.3f} GB) "
          f"{cold_s:.3f} s; {loader.ims_per_batch} frames a step, B={b}, window "
          f"{loader.cfg.sample_window}")
    print(f"B={b} from disk, launches in the step {launch_counts()}")
    print(f"B={b} from disk, {UNPROFILED_STEPS} steps without the profiler: {marks['step_ms']:.3f} "
          f"ms a step (host clock), peak memory {marks['peak']:.2f} GiB")
    print(f"B={b} from disk, one train step: wall {marks['wall_ms']:.3f} ms, device kernels "
          f"{device_ms:.3f} ms, idle share {1 - device_ms / marks['wall_ms']:.4f}")
    for e in events:
        if e.key.startswith(("train.", "Optimizer.step")):
            side = "device span" if e.device_type == DeviceType.CUDA else "host"
            ms = (device_us(e) if e.device_type == DeviceType.CUDA else e.cpu_time_total) / 1e3
            print(f"range {e.key}: calls {e.count}, {side} {ms:.3f} ms")
    print_kernels(kernels, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
