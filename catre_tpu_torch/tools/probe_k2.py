"""Short card check of K2's bf16 kernel (`csrc/encoder_stn_tail_wgmma.cuh`) after
an edit of its sources, and of the bf16 K5 forward, the same kernel with kIdx.

    python -m catre_tpu_torch.tools.probe_k2 [--time-batch 256] [--skip-x] [--train]

Builds `encoder_epilogue` and `encoder_epilogue_train` (the K5 forward) and
prints what ptxas says of both instantiations (registers, stack frame,
spills, any warning) with their shared memory, the card's name and power
limit, then K2 against its plain version and against the plain version of
its own order (`dense_relu_max_folded_twin`) at N = 1, 3 and 8 clouds (fewer
work items than SMs) of P = 1024, 1000 (a tile the 128-point tile does not
fill) and 40 points (a slot less than one warp's 16 rows full), bf16 and f32,
whether four launches give the same bits, and whether the K5 forward's `out`
is K2's. With `--time-batch B` it times K2 at 2 B clouds of 1024 points in
bf16 (CUDA events, 10 launches after 2) beside the K5 forward in the same
process, and splits one launch by device kernel under `torch.profiler`.
`--skip-x` also times a diagnostic build whose producer loads x for a
block's first cloud only (later clouds read stale slots: a wrong result, the
time without x's traffic from L2 and device memory). `--train` checks the K5
forward's out and idx on exact-integer operands (x in {0, 1, 2}, weights in
{-2 .. 2}, integer biases, a quarter of the channels at -50 so that every row
ties at 0; out and idx bit-equal to the plain version's, out to K2's) at 8
clouds of P = 1024, 1000, 100 and 40 points, widths 128 -> 1024 and 64 ->
640, f32 and bf16, then times K2 and the K5 forward at 1024 clouds of 1024
points beside a diagnostic build of the K5 forward that folds the bare
accumulator as K2 does (`CATRE_K5F_BARE_FOLD`: idx = 0, the time without the
keyed fold).
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
from .probe_k1 import time_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
KERNEL = "dense_relu_max_wgmmaILi8ELi2ELb0E"         # the bf16 K2 at cin = 128
K5F_KERNEL = "dense_relu_max_wgmmaILi8ELi2ELb1E"     # the same with kIdx: the bf16 K5 forward
SKIP_X = "CATRE_K2_SKIP_X_LOADS"
BARE_FOLD = "CATRE_K5F_BARE_FOLD"
REPEATS = 4
TRAIN_CLOUDS = 1024          # the train step's clouds per K5 forward (2 x B = 512)


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
    ap.add_argument("--train", action="store_true",
                    help="also check the K5 forward's idx and time it at 1024 clouds")
    args = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(("encoder_epilogue", "encoder_epilogue_train"))
    for line in _build.build_log("encoder_epilogue").splitlines():
        if "warning" in line.lower():
            print(line.strip(), flush=True)
    for line in _build.build_log("encoder_epilogue_train").splitlines():
        if "warning" in line.lower():
            print(line.strip(), flush=True)
    lib = enc_ops._lib()
    print(f"{KERNEL}: {_build.ptxas_report('encoder_epilogue', KERNEL)}, "
          f"{lib.catre_stn_tail_smem()} bytes of dynamic shared memory, "
          f"{lib.catre_stn_tail_chunks()} chunks of 128 channels a block", flush=True)
    print(f"{K5F_KERNEL}: {_build.ptxas_report('encoder_epilogue_train', K5F_KERNEL)}, "
          f"{train_ops._lib().catre_k5_fwd_smem()} bytes of dynamic shared memory, "
          f"{train_ops._lib().catre_k5_fwd_chunks()} chunks of 128 channels a block", flush=True)
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
                    ok = (err <= TOL[cdt] * scale and err_f <= TOL[cdt] * scale
                          and torch.equal(k5, out))
                    print(f"{'ok  ' if ok else 'FAIL'} {str(cdt)[6:]} N={n} P={p}: err vs plain "
                          f"{err:.3e}, vs folded {err_f:.3e} (limit {TOL[cdt] * scale:.3e}); "
                          f"mean |k - folded| {(out - folded).abs().mean().item():.3e}, "
                          f"mean |plain - folded| {(plain - folded).abs().mean().item():.3e}; "
                          f"finite {bool(torch.isfinite(out).all())}, {REPEATS} launches bit_equal "
                          f"{all(torch.equal(out, o) for o in outs[1:])}; K5 fwd out equal to "
                          f"K2's {torch.equal(k5, out)}", flush=True)
    if args.train:
        train(dev, w, b)
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


def int_case(gen, dev, n, p, cin, cout):
    """Exact-integer K5 operands: every f32 sum an integer below 2^24, exact
    in any order, so the card's rounded values are the plain version's bit
    for bit while the bf16 roundings tie rows whose sums differ; a quarter of
    the channels with weights at or below 0 and a bias of -50, where every
    row is negative before the ReLU and ties at 0 after it."""
    x = torch.randint(0, 3, (n, p, cin), device=dev, generator=gen).float()
    w = torch.randint(-2, 3, (cout, cin), device=dev, generator=gen).float()
    b = torch.randint(-8, 9, (cout,), device=dev, generator=gen).float()
    w[::4], b[::4] = -w[::4].abs(), -50.0
    return x, w, b


def train(dev, w, b):
    """The K5 forward's idx on exact-integer operands, then its time at the
    train step's 1024 clouds beside K2 and the diagnostic build."""
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for cin, cout in ((128, 1024), (64, 640)):
            for p in (1024, 1000, 100, 40):
                x32, w_int, b_int = int_case(gen, dev, 8, p, cin, cout)
                for cdt in (torch.bfloat16, torch.float32):
                    x = x32.to(cdt)
                    out, idx = train_ops.dense_relu_max_fwd(x, w_int, b_int, cdt)
                    out_p, idx_p = train_ops.dense_relu_max_fwd_plain(x, w_int, b_int, cdt)
                    k2 = enc_ops.dense_relu_max(x, w_int, b_int, cdt)
                    torch.cuda.synchronize()
                    dead = (idx[:, ::4] == 0).all().item()
                    ok = (torch.equal(idx, idx_p) and torch.equal(out, out_p)
                          and torch.equal(out, k2) and dead)
                    print(f"{'ok' if ok else 'FAIL'} K5 fwd {str(cdt)[6:]} integer operands N=8 "
                          f"P={p} {cin}->{cout}: idx differs at {(idx != idx_p).sum().item()} of "
                          f"{idx.numel()}, out equal {torch.equal(out, out_p)}, out equal to K2 "
                          f"{torch.equal(out, k2)}, channels at -50 all idx 0 {dead}", flush=True)
    bf = torch.bfloat16
    x = torch.relu(torch.randn(TRAIN_CLOUDS, 1024, 128, device=dev, generator=gen)).to(bf)
    cout = w.shape[0]
    lib = ctypes.CDLL(str(_build.build("encoder_epilogue_train", (BARE_FOLD,))))
    lib.catre_dense_relu_max_train_fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.catre_k5_fwd_chunks.restype = ctypes.c_int
    wc, bc = w.to(bf).contiguous(), b.to(bf).float()
    grid, _ = enc_ops.stn_tail_grid(TRAIN_CLOUDS, cout, enc_ops._sm_count(dev.index),
                                    lib.catre_k5_fwd_chunks())
    out = torch.empty(TRAIN_CLOUDS, cout, device=dev)
    idx = torch.empty(TRAIN_CLOUDS, cout, device=dev, dtype=torch.int32)
    stream = _build.stream_handle(dev)

    def bare():
        _build.check(lib.catre_dense_relu_max_train_fwd(
            x.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(), idx.data_ptr(),
            TRAIN_CLOUDS, 1024, 128, cout, 1, grid, stream), "diagnostic K5 forward")

    with torch.no_grad():
        times = {"K2": lambda: enc_ops.dense_relu_max(x, w, b, bf),
                 "K5 fwd": lambda: train_ops.dense_relu_max_fwd(x, w, b, bf),
                 "K5 fwd, bare fold (diagnostic, idx = 0)": bare}
        line = ", ".join(f"{name} {time_ms(fn):.4f} ms" for name, fn in times.items())
        bare()
        k2 = enc_ops.dense_relu_max(x, w, b, bf)
        torch.cuda.synchronize()
    flops = 2 * TRAIN_CLOUDS * 1024 * 128 * cout
    print(f"bf16 N={TRAIN_CLOUDS} P=1024: {line}; bound {flops / 989e12 * 1e3:.4f} ms; the bare "
          f"fold's out equal to K2's {torch.equal(out, k2)}", flush=True)


if __name__ == "__main__":
    main()
