"""Where the time of the sample path goes, on one CUDA card.

    python -m catre_tpu_torch.tools.profile_sample [--window -1] [--top 12]

Makes the frames of `chip_smoke.py` phase 5c (`entry.example_frames`: 32
frames of 480 x 640, 8 instance slots, NUM_PCL and the ratio of the shipped
config; `--window -1` is the auto window, 0 the full frame), takes a warm-up
of each part, then profiles under `torch.profiler`: the candidates half alone,
the select half alone, and one call of the path a user runs (host frames ->
`make_group_sampler` with its own draws -> the shipped refine at B = 256).
For each it prints the wall time, the summed device time of its kernels, the
idle share (1 - device / wall) and the PyTorch operators ranked by the device
time of the kernels they launch.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config.build import FLAGSHIP_CONFIG, loader_config_from
from ..config.loader import load_config
from ..data import loader as dl
from ..entry import entry, example_frames
from ..ops.sampling import batch_ball_crop_candidates, batch_select_from_candidates
from .profile_train import card_line, device_kernels, device_us


def profiled(tag: str, fn, top: int) -> None:
    fn()                                                             # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    device_ms = sum(device_us(e) for e in device_kernels(events)) / 1e3
    print(f"{tag}: wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} ms, idle share "
          f"{1 - device_ms / wall_ms:.4f}")
    ops = [e for e in events if e.device_type == DeviceType.CPU and device_us(e) > 0]
    print(f"{'device ms':>10} {'calls':>6} {'share':>6}  operator")
    for e in sorted(ops, key=device_us, reverse=True)[:top]:
        ms = device_us(e) / 1e3
        print(f"{ms:10.3f} {e.count:6d} {ms / device_ms:6.1%}  {e.key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", type=int, default=-1)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sample needs a CUDA card")
    shipped = load_config(str(FLAGSHIP_CONFIG))
    lcfg = loader_config_from(shipped, "test")
    ims, m = int(shipped.TEST.IMS_PER_BATCH), lcfg.max_objs_per_image
    f = example_frames(ims, 480, 640, m=m, seed=0)
    ws = dl.auto_sample_window(f["records"], "test") if args.window < 0 else args.window
    cfg = dataclasses.replace(lcfg, sample_window=ws)
    host = [f[k] for k in ("depth", "K", "packed", "poses", "scales", "mask_bbox")]
    d = [dl.to_device(a, "cuda") for a in host]
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"card: {card_line()}")
    print(f"{ims} frames 480x640, {ims * m} slots, NUM_PCL {cfg.num_pcl}, window {ws}")
    if ws:
        cand_args = (d[0], d[1], d[2], d[5], d[3], d[4], cfg.depth_sample_ball_ratio, ws)
        cand = batch_ball_crop_candidates(*cand_args)
        profiled("candidates", lambda: batch_ball_crop_candidates(*cand_args), args.top)
        profiled("select", lambda: batch_select_from_candidates(
            *cand, cfg.num_pcl, 640, ws, generator=gen), args.top)
        del cand
    else:
        profiled("full frame group", lambda: dl.sample_group_from_cloud(
            cfg, False, *d[:5], generator=gen), args.top)
    sampler = dl.make_group_sampler(cfg, False, device="cuda")
    b = ims * m
    refine, inputs = entry("cuda", batch_size=b, seed=0)
    K = d[1].repeat_interleave(m, dim=0)

    def sample_and_refine():
        pcl, _, _ = sampler(*host, generator=gen)
        return refine(pcl.reshape(b, cfg.num_pcl, 3), inputs[1], d[3].reshape(b, 3, 4),
                      d[4].reshape(b, 3), K, inputs[5])

    profiled(f"sample + refine, B={b}", sample_and_refine, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
