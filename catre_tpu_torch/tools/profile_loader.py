"""The shipped test loader over a split read from disk, on one CUDA card.

    python -m catre_tpu_torch.tools.profile_loader [--frames 2752] [--top 12]

Writes `--frames` frames of 480 x 640 with 8 slots (`entry.write_example_split`)
to a temporary directory and reads them through the shipped config's test
loader (`entry.shipped_test_loader`: device cache, frozen plan, auto window,
32 images a group; presampled candidates while they fit under the 6 GB guard,
else the cached sampler) into the shipped refine, the keypoints gathered on
the card from a seeded mean-shape table. Prints the card's name and power
limit; the write time; `data/png.py`'s decode time a frame (one thread); the
device cache's build time and size; the candidates' size against the guard
and the sampler that ran; the cold pass; warm passes in obj/s (slots, and
real objects); one warm pass under `torch.profiler` with its wall time, the
summed device time of its kernels, the idle share (1 - device / wall, and
against the wall of the last unprofiled pass, which bears no profiler cost) and
the operators ranked by the device time of their kernels; and one uncached pass
(the shipped config's 4 decode threads, pinned buffers, a side stream).

`--evaluate` also runs the device-cache loader's passes through
`eval.run_inference` into a `CATREEvaluator` (the shipped refine, the packed
inputs, prefetch 2): a warm pass, a timed pass without probes (images/s, slot
and real obj/s, `overlap_fetch_s_per_img`, `process_s_per_img`, then the
seconds of `evaluate()` over the 5 iterations), a pass with the default probe
(`compute_s_per_img`) and a timed pass under `torch.profiler` (wall, device
time and idle share, as for the loader's pass).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..data import loader as dl
from ..entry import N_ITER, entry, loader_refine_args, shipped_test_loader, write_example_split
from ..eval.evaluator import CATREEvaluator, run_inference
from .profile_train import card_line, device_kernels, device_us


def run_pass(loader, refine, table) -> float:
    start = time.perf_counter()
    for batch in loader:
        poses, _ = refine(*loader_refine_args(batch, table))
    torch.cuda.synchronize()
    if not torch.isfinite(poses).all():
        raise RuntimeError("refined poses not finite")
    return time.perf_counter() - start


def evaluate_passes(loader, refine, table, records, n_objs, m) -> None:
    """The loader's passes through `run_inference` and the evaluator (see
    `--evaluate` in the module docstring)."""
    def run(**kw):
        loader.reset_stream()
        ev = CATREEvaluator(records, n_iters=N_ITER)
        return run_inference(refine, loader, ev, N_ITER, mean_table=table, **kw), ev

    run(compute_probe_every=0)                                   # warm
    stats, ev = run(warmup=0, compute_probe_every=0)
    s, n = stats["total_s"], stats["images"]
    print(f"evaluate, timed pass (no probe, prefetch 2): {n} images in {s:.4f} s, "
          f"{n / s:.1f} images/s, {n * m / s:.1f} slot obj/s, {n_objs / s:.1f} real obj/s; "
          f"overlap_fetch_s_per_img {stats['overlap_fetch_s_per_img']:.6f}, process_s_per_img "
          f"{stats['process_s_per_img']:.6f}")
    t0 = time.perf_counter()
    results = ev.evaluate(dump=False)
    print(f"evaluate(): {time.perf_counter() - t0:.3f} s over {len(results)} iterations; "
          f"iteration 0 IoU75 {results[0]['summary']['IoU75']:.2f}, te2 "
          f"{results[0]['summary']['te2']:.2f}")
    stats, _ = run()
    print(f"evaluate, probed pass (every 8th batch after 1 of warm-up): compute_s_per_img "
          f"{stats['compute_s_per_img']:.6f}, overlap_fetch_s_per_img "
          f"{stats['overlap_fetch_s_per_img']:.6f}, process_s_per_img "
          f"{stats['process_s_per_img']:.6f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats, _ = run(warmup=0, compute_probe_every=0)
    device_ms = sum(device_us(e) for e in device_kernels(prof.key_averages())) / 1e3
    wall = stats["total_s"] * 1e3
    print(f"evaluate, profiled timed pass: wall {wall:.3f} ms, device kernels {device_ms:.3f} ms, "
          f"idle share {1 - device_ms / wall:.4f}; against the unprofiled timed pass's wall "
          f"({s * 1e3:.3f} ms) {1 - device_ms / (s * 1e3):.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2752)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--evaluate", action="store_true",
                    help="also run the passes through run_inference and the evaluator")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_loader needs a CUDA card")
    print(f"card: {card_line()}")
    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32) * 0.1
    table_dev = torch.from_numpy(table).cuda()
    kw = dict(mean_points=table, ship_mean_points=False)
    with tempfile.TemporaryDirectory(prefix="catre_split_") as root:
        t0 = time.perf_counter()
        records = write_example_split(root, args.frames)
        n_objs = sum(len(r["annotations"]) for r in records)
        print(f"wrote {args.frames} frames ({n_objs} objects) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for r in records[:32]:
            dl.load_depth(r["depth_file"])
        print(f"png.py decode: {(time.perf_counter() - t0) / 32 * 1e3:.3f} ms a depth frame "
              "(one thread)")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loader = shipped_test_loader(records, "cuda", **kw)
        torch.cuda.synchronize()
        print(f"device cache: {time.perf_counter() - t0:.3f} s to decode ({loader.num_workers} "
              f"threads) and upload, {loader.device_cache_gb():.3f} GB")
        ims, m = loader.ims_per_batch, loader.cfg.max_objs_per_image
        pre = loader._ensure_candidates()
        print(f"presampled candidates {loader.candidates_gb():.3f} GB against the "
              f"{loader.presampled_max_gb} GB guard: "
              f"{'presampled sampler' if pre is not None else 'cached sampler'} runs; window "
              f"{loader.cfg.sample_window}")
        del pre
        refine, _ = entry("cuda", batch_size=ims * m, seed=0)
        cold = run_pass(loader, refine, table_dev)
        print(f"cold pass (plan, candidates, sampling, refine): {cold:.3f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        for i in range(2):
            loader.reset_stream()
            s = run_pass(loader, refine, table_dev)
            print(f"warm pass {i + 1}: {s:.4f} s, {args.frames * m / s:.1f} obj/s, "
                  f"{n_objs / s:.1f} real objects/s")
        loader.reset_stream()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run_pass(loader, refine, table_dev)
        events = prof.key_averages()
        device_ms = sum(device_us(e) for e in device_kernels(events)) / 1e3
        print(f"profiled warm pass: wall {wall * 1e3:.3f} ms, device kernels {device_ms:.3f} ms, "
              f"idle share {1 - device_ms / (wall * 1e3):.4f}; against the last unprofiled "
              f"pass's wall ({s * 1e3:.3f} ms, no profiler cost) {1 - device_ms / (s * 1e3):.4f}")
        ops = [e for e in events if e.device_type == DeviceType.CPU and device_us(e) > 0]
        print(f"{'device ms':>10} {'calls':>6} {'share':>6}  operator")
        for e in sorted(ops, key=device_us, reverse=True)[:args.top]:
            ms = device_us(e) / 1e3
            print(f"{ms:10.3f} {e.count:6d} {ms / device_ms:6.1%}  {e.key[:100]}")
        if args.evaluate:
            evaluate_passes(loader, refine, table, records, n_objs, m)
        del loader
        dl.clear_decoded_caches()
        torch.cuda.empty_cache()

        unc = shipped_test_loader(records, "cuda", cache_decoded="", **kw)
        s = run_pass(unc, refine, table_dev)
        print(f"uncached pass ({unc.num_workers} threads, pinned, side stream): {s:.4f} s, "
              f"{args.frames * m / s:.1f} obj/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
