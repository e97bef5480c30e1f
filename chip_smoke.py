#!/usr/bin/env python3
"""Smoke check of the PyTorch/H100 port (`catre_tpu_torch`) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It imports no JAX. Phases, one line each (any failure raises, so the exit
code is non-zero):
  1. device:   the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build:    compile the CUDA kernels from catre_tpu_torch/csrc with nvcc;
  3. kernels:  K1, K2 and K3 vs their plain PyTorch twins at main-path shapes,
               in f32 (tight) and bf16 (loose), and their times;
  4. identity: canned identity-delta heads with init = gt: 4 refine
               iterations must return the init;
  5. refine:   the flagship refine from `catre_tpu_torch.entry.entry` (shipped
               ..._120e_tpu.py config: bf16, fused kernels, 1024 + 1024
               points, 4 iterations, seeded weights) at B = 256 and 2048:
               finite outputs, obj/s from CUDA events, and exactly K1 = 4,
               K2 = 8, K3 = 4 launches per call;
               plus a B = 8 f32 run of the kernel path against the plain path.
Then one JSON line of per-kernel results, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.
"""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import torch

KERNEL_B = 256               # objects for the kernel checks (512 clouds)
REFINE_BATCHES = (256, 2048)
REFINE_CALLS = 3             # timed refine calls per batch size, after one warm-up
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # x max(1, max|twin|)
PATH_TOL = 5e-4              # kernel path vs plain path, f32 (the CPU slice tolerance)
IDENTITY_TOL = 1e-5


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(name, kernel, twin, make_args):
    """Kernel vs twin in f32 and bf16 (no launch counting here); times in bf16."""
    errs = {}
    for cdt in (torch.float32, torch.bfloat16):
        args = make_args(cdt)
        ref = twin(*args)
        out = kernel(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise RuntimeError(f"{name} {cdt}: shape {tuple(out.shape)} or non-finite output")
        err = (out - ref).abs().max().item()
        limit = TOL[cdt] * max(1.0, ref.abs().max().item())
        log("kernels", f"{name} {str(cdt)[6:]} max_abs_err={err:.3e} limit={limit:.3e}")
        if not err <= limit:
            raise RuntimeError(f"{name} {cdt}: kernel disagrees with its twin: {err} > {limit}")
        errs[cdt] = err
    args = make_args(torch.bfloat16)
    ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: twin(*args))
    log("kernels", f"{name} bf16 kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    return {"max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "plain_ms": plain_ms}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from catre_tpu_torch import ops
    from catre_tpu_torch.engine.refiner import make_refine_fn
    from catre_tpu_torch.entry import (N_ITER, entry, example_batch, flagship_config,
                                       near_identity_model)
    from catre_tpu_torch.geom.rotations import rot6d_to_mat
    from catre_tpu_torch.models.catre import init_model
    from catre_tpu_torch.ops import _build
    from catre_tpu_torch.ops import encoder_epilogue as enc_ops
    from catre_tpu_torch.ops import rot_head as rot_ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 1. device
    card = card_line()
    log("device", f"{card} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
                  f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    log("build", f"{len(_build.KERNEL_SOURCES)} libraries in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels vs twins at main-path shapes, weights of the seeded flagship model
    cfg = flagship_config()
    model = init_model(cfg, seed=0, device=dev)
    enc = model.pcl_net
    gen = torch.Generator(device=dev).manual_seed(0)
    n_clouds, n_pts = 2 * KERNEL_B, cfg.num_pcl
    x_stn = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=gen))
    x_main = torch.relu(torch.randn(n_clouds, n_pts, 128, device=dev, generator=gen))
    head = copy.deepcopy(model.rot_head)
    with torch.no_grad():
        for prm in head.parameters():
            prm.mul_(50.0)                       # signal well above the 1e-3 init
    pf = torch.randn(KERNEL_B, 2 * n_pts, 64, device=dev, generator=gen) * 0.5
    g2 = torch.randn(KERNEL_B, 2, 1024, device=dev, generator=gen) * 0.5
    results = {}
    with torch.no_grad():
        results["K2"] = check_kernel(
            "K2 dense_relu_max", enc_ops.dense_relu_max, enc_ops.dense_relu_max_twin,
            lambda cdt: (x_stn.to(cdt), enc.stn.conv3.weight, enc.stn.conv3.bias, cdt))
        results["K1"] = check_kernel(
            "K1 dense_relu_dense_max", enc_ops.dense_relu_dense_max,
            enc_ops.dense_relu_dense_max_twin,
            lambda cdt: (x_main.to(cdt), enc.conv3.weight, enc.conv3.bias, enc.conv4.weight,
                         enc.conv4.bias, cdt))

        def rot_args(cdt):
            pack = rot_ops.pack_rot_head(head, cdt)
            return pf.to(cdt), (g2 @ pack.w_g.T).contiguous(), pack, n_pts

        results["K3"] = check_kernel("K3 rot_head", rot_ops.rot_head, rot_ops.rot_head_twin,
                                     rot_args)

    # ---- 4. identity: canned identity-delta heads, init = gt, 4 iterations
    ident = near_identity_model(model)
    b = example_batch(KERNEL_B, cfg.num_pcl, cfg.num_kps, device=dev, seed=1)
    rot_init = rot6d_to_mat(torch.randn(KERNEL_B, 6, device=dev, generator=gen))
    t_init = torch.stack([torch.rand(KERNEL_B, device=dev, generator=gen) * 0.4 - 0.2,
                          torch.rand(KERNEL_B, device=dev, generator=gen) * 0.4 - 0.2,
                          torch.rand(KERNEL_B, device=dev, generator=gen) * 0.6 + 0.6], dim=1)
    pose_init = torch.cat([rot_init, t_init[:, :, None]], dim=2)
    poses, scales = make_refine_fn(ident, N_ITER)(b["pcl"], b["obj_kps"], pose_init,
                                                  b["obj_scale"], b["K"])
    dp = (poses - pose_init[None]).abs().max().item()
    ds = (scales - b["obj_scale"][None]).abs().max().item()
    log("identity", f"B={KERNEL_B} x{N_ITER} iterations: max |pose - init| = {dp:.3e}, "
                    f"max |scale - init| = {ds:.3e}, limit {IDENTITY_TOL:.0e}")
    if not (dp <= IDENTITY_TOL and ds <= IDENTITY_TOL):
        raise RuntimeError("identity-delta refine moved the init")

    # ---- 5a. reference: kernel path vs plain path, f32, small batch
    cfg32 = dataclasses.replace(cfg, dtype=None)
    m32 = init_model(cfg32, seed=0, device=dev)
    b8 = example_batch(8, cfg.num_pcl, cfg.num_kps, device=dev, seed=2)
    args8 = (b8["pcl"], b8["obj_kps"], b8["obj_pose"], b8["obj_scale"], b8["K"])
    fused = make_refine_fn(m32, N_ITER)(*args8)
    m32.cfg = dataclasses.replace(cfg32, fused_heads=False)
    plain = make_refine_fn(m32, N_ITER)(*args8)
    derr = max((a - p).abs().max().item() for a, p in zip(fused, plain))
    log("refine", f"B=8 f32 kernel path vs plain path: max_abs_err={derr:.3e} "
                  f"limit={PATH_TOL:.0e}")
    if not derr <= PATH_TOL:
        raise RuntimeError("the kernel path disagrees with the plain path")

    # ---- 5b. the main path, through the port's entry point: flagship refine, bf16, kernels
    per_call = {"dense_relu_dense_max": N_ITER, "dense_relu_max": 2 * N_ITER,
                "rot_head": N_ITER}
    launches = dict.fromkeys(per_call, 0)
    for B in REFINE_BATCHES:
        refine, args = entry(dev, batch_size=B, seed=0)
        refine(*args)                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        start.record()
        for _ in range(REFINE_CALLS):
            poses, scales = refine(*args)
        end.record()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ms = start.elapsed_time(end) / REFINE_CALLS
        want = {k: v * REFINE_CALLS for k, v in per_call.items()}
        if counts != want:
            raise RuntimeError(f"B={B}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        if poses.shape != (N_ITER + 1, B, 3, 4) or scales.shape != (N_ITER + 1, B, 3):
            raise RuntimeError(f"B={B}: shapes {tuple(poses.shape)} {tuple(scales.shape)}")
        if not (torch.isfinite(poses).all() and torch.isfinite(scales).all()):
            raise RuntimeError(f"B={B}: non-finite refine output")
        log("refine", f"B={B} bf16 {N_ITER} iterations: {ms:.3f} ms/call, "
                      f"{B / ms * 1e3:.1f} obj/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                      f" GiB, launches per call {dict((k, v // REFINE_CALLS) for k, v in counts.items())}")

    kernels = [
        dict(name="K1 dense_relu_dense_max", route="cuda",
             source="catre_tpu_torch/csrc/encoder_epilogue.cu",
             replaces="catre_tpu/ops/pallas_encoder_epilogue.py:98",
             launches=launches["dense_relu_dense_max"], **results["K1"]),
        dict(name="K2 dense_relu_max", route="cuda",
             source="catre_tpu_torch/csrc/encoder_epilogue.cu",
             replaces="catre_tpu/ops/pallas_encoder_epilogue.py:89",
             launches=launches["dense_relu_max"], **results["K2"]),
        dict(name="K3 rot_head", route="cuda", source="catre_tpu_torch/csrc/rot_head.cu",
             replaces="catre_tpu/ops/pallas_heads.py:276",
             launches=launches["rot_head"], **results["K3"]),
    ]
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError("a kernel of the main path never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
