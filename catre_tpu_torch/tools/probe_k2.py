"""Short card check of K2's bf16 kernel (`csrc/encoder_stn_tail_wgmma.cuh`) after
an edit of its sources.

    python -m catre_tpu_torch.tools.probe_k2 [--time-batch 256] [--skip-x]

Builds `encoder_epilogue` (and `encoder_epilogue_train`, for the K5 forward)
and prints what ptxas says of K2's kernel (registers, stack frame, spills,
any warning), its shared memory, the card's name and power limit, then K2
against its plain version and against the plain version of its own order
(`dense_relu_max_folded_twin`) at N = 1, 3 and 8 clouds (fewer work items
than SMs) of P = 1024, 1000 (a tile the 128-point tile does not fill) and 40
points (a slot less than one warp's 16 rows full), bf16 and f32, whether four
launches give the same bits, and how far the K5 forward's `out` (the old
`mma.sync` body) lies from K2's. With `--time-batch B` it times K2 at 2 B
clouds of 1024 points in bf16 (CUDA events, 10 launches after 2) beside the
K5 forward in the same process, and splits one launch by device kernel under
`torch.profiler`. `--skip-x` also times a diagnostic build whose producer
loads x for a block's first cloud only (later clouds read stale slots: a
wrong result, the time without x's traffic from L2 and device memory).
"""

import argparse
import ctypes
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..entry import flagship_config
from ..models.catre import init_model
from ..ops import _build
from ..ops import encoder_epilogue as enc_ops
from ..ops import encoder_epilogue_train as train_ops
from .probe_k1 import bf16_spacings, time_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
KERNEL = "dense_relu_max_wgmmaILi8E"                  # the bf16 K2 at cin = 128
SKIP_X = "CATRE_K2_SKIP_X_LOADS"
REPEATS = 4


def bind(path):
    lib = ctypes.CDLL(str(path))
    lib.catre_dense_relu_max.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.catre_stn_tail_chunks.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time the bf16 kernel at 2 x this many clouds")
    ap.add_argument("--skip-x", action="store_true",
                    help="also time the diagnostic build that loads x for a block's first cloud only")
    args = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(("encoder_epilogue", "encoder_epilogue_train"))
    for line in _build.build_log("encoder_epilogue").splitlines():
        if "warning" in line.lower():
            print(line.strip(), flush=True)
    lib = enc_ops._lib()
    print(f"{KERNEL}: {_build.ptxas_report('encoder_epilogue', KERNEL)}, "
          f"{lib.catre_stn_tail_smem()} bytes of dynamic shared memory, "
          f"{lib.catre_stn_tail_chunks()} chunks of 128 channels a block", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    stn = init_model(flagship_config(), seed=0, device=dev).pcl_net.stn
    w, b = stn.conv3.weight.detach(), stn.conv3.bias.detach()
    gen = torch.Generator(device=dev).manual_seed(0)

    def cloud(n, p):
        return torch.relu(torch.randn(n, p, 128, device=dev, generator=gen))

    with torch.no_grad():
        for p in (1024, 1000, 40):
            for n in (1, 3, 8):
                x32 = cloud(n, p)
                for cdt in (torch.bfloat16, torch.float32):
                    x = x32.to(cdt)
                    outs = [enc_ops.dense_relu_max(x, w, b, cdt) for _ in range(REPEATS)]
                    out = outs[0]
                    plain = enc_ops.dense_relu_max_twin(x, w, b, cdt)
                    folded = enc_ops.dense_relu_max_folded_twin(x, w, b, cdt)
                    k5, _ = train_ops.dense_relu_max_fwd(x, w, b, cdt)
                    torch.cuda.synchronize()
                    scale = max(1.0, plain.abs().max().item())
                    err, err_f = (out - plain).abs().max().item(), (out - folded).abs().max().item()
                    ok = err <= TOL[cdt] * scale and err_f <= TOL[cdt] * scale
                    print(f"{'ok  ' if ok else 'FAIL'} {str(cdt)[6:]} N={n} P={p}: err vs plain "
                          f"{err:.3e}, vs folded {err_f:.3e} (limit {TOL[cdt] * scale:.3e}); "
                          f"mean |k - folded| {(out - folded).abs().mean().item():.3e}, "
                          f"mean |plain - folded| {(plain - folded).abs().mean().item():.3e}; "
                          f"finite {bool(torch.isfinite(out).all())}, {REPEATS} launches bit_equal "
                          f"{all(torch.equal(out, o) for o in outs[1:])}; K5 fwd vs K2: "
                          f"{(k5 != out).float().mean().item():.4%} differ, at most "
                          f"{bf16_spacings(k5, out).max().item():.2f} bf16 spacings", flush=True)
    if not args.time_batch:
        return
    x = cloud(2 * args.time_batch, 1024).bfloat16()
    bf = torch.bfloat16
    n_clouds = x.shape[0]
    with torch.no_grad():
        ms = time_ms(lambda: enc_ops.dense_relu_max(x, w, b, bf))
        k5_ms = time_ms(lambda: train_ops.dense_relu_max_fwd(x, w, b, bf))
        flops = 2 * n_clouds * 1024 * 128 * 1024
        print(f"K2 bf16 N={n_clouds}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"bound {flops / 989e12 * 1e3:.4f} ms); K5 fwd {k5_ms:.4f} ms", flush=True)
        if args.skip_x:
            diag = bind(_build.build("encoder_epilogue", (SKIP_X,)))
            wc, bc = w.to(bf).contiguous(), b.to(bf).float()
            grid, _ = enc_ops.stn_tail_grid(n_clouds, 1024, enc_ops._sm_count(dev.index),
                                            diag.catre_stn_tail_chunks())
            out = torch.empty(n_clouds, 1024, device=dev)
            stream = _build.stream_handle(dev)

            def run_diag():
                _build.check(diag.catre_dense_relu_max(
                    x.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(), n_clouds, 1024,
                    128, 1024, 1, grid, stream), "diagnostic K2")
            diag_ms = time_ms(run_diag)
            print(f"K2 with x for a block's first cloud only (diagnostic, wrong result): "
                  f"{diag_ms:.4f} ms, {(ms - diag_ms) / ms:.1%} below K2", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            enc_ops.dense_relu_max(x, w, b, bf)
            torch.cuda.synchronize()
    for ev in sorted(prof.key_averages(), key=lambda ev: -ev.device_time_total)[:8]:
        if ev.device_time_total:
            print(f"  {ev.device_time_total / 1e3:9.4f} ms x{ev.count:3d}  {ev.key[:90]}", flush=True)
    grid, groups = enc_ops.stn_tail_grid(n_clouds, 1024, enc_ops._sm_count(dev.index),
                                         lib.catre_stn_tail_chunks())
    x_bytes = x.numel() * 2
    print(f"grid {grid} blocks, {groups} groups; x from L2 {groups} times: "
          f"{groups * x_bytes / 1e9:.2f} GB a launch, {groups * x_bytes / ms / 1e9:.2f} TB/s at "
          f"K2's time", flush=True)


if __name__ == "__main__":
    main()
