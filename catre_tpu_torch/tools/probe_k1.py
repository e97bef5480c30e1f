"""Short card check of K1's bf16 kernel (`csrc/encoder_tail_wgmma.cuh`) after
an edit of its sources, and of the bf16 K6 forward, the same body with kIdx.

    python -m catre_tpu_torch.tools.probe_k1 [--time-batch 256] [--skip-w4] [--train]

Builds `encoder_epilogue` and `encoder_epilogue_train` (the K6 forward) and
prints what ptxas says of both instantiations (registers, spills, stack
frame, any warning), the card's name and power limit, then K1 against its
plain version and against the plain version of its own order
(`dense_relu_dense_max_folded_twin`) at 8 clouds of 1024 points and of 1000 (a
tile the 128-point tile does not fill), bf16 and f32, whether a second launch
gives the same bits, and whether the K6 forward's `out` is K1's. With
`--time-batch B` it times K1 at 2 B clouds of 1024 points in bf16 (CUDA
events, 10 launches after 2) beside the K6 forward in the same process, and
splits one launch by device kernel under `torch.profiler`. `--skip-w4` also
times a diagnostic build whose producer loads no W4 stage (GEMM2 reads stale
stages: a wrong result, the time without W4's traffic from L2). `--train`
checks the K6 forward's idx on exact-integer operands (x in {0, 1, 2},
weights in {-2 .. 2}: bit-equal to the plain version's) at 8 clouds of 1024
and 1000 points, then times K1 and the K6 forward at 1024 clouds of 1024
points beside a diagnostic build of the K6 forward that folds the bare
accumulator as K1 does (`CATRE_K6F_BARE_FOLD`: idx = 0, the time without the
rounded fold).
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

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
KERNELS = ("dense_relu_dense_max_wgmma", "dense_relu_dense_max_kernelILb0")
K6F_KERNELS = ("dense_relu_dense_max_wgmmaILi8ELb1E", "dense_relu_dense_max_kernelILb1")
SKIP_W4 = "CATRE_K1_SKIP_W4_LOADS"
BARE_FOLD = "CATRE_K6F_BARE_FOLD"
TRAIN_CLOUDS = 1024          # the train step's clouds per K6 forward (2 x B = 512)


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


def bf16_spacings(a, b):
    """|a - b| in units of the bf16 spacing at |b| (2^-7 |b|, at least the
    smallest normal's)."""
    scale = torch.clamp(b.abs(), min=torch.finfo(torch.bfloat16).tiny) * 2.0 ** -7
    return (a - b).abs() / scale


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time the bf16 kernel at 2 x this many clouds")
    ap.add_argument("--skip-w4", action="store_true",
                    help="also time the diagnostic build that loads no W4 stage")
    ap.add_argument("--train", action="store_true",
                    help="also check the K6 forward's idx and time it at 1024 clouds")
    args = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(("encoder_epilogue", "encoder_epilogue_train"))
    for line in _build.build_log("encoder_epilogue").splitlines():
        if "warning" in line.lower():
            print(line.strip(), flush=True)
    for kernel in KERNELS:
        print(f"{kernel}: {_build.ptxas_report('encoder_epilogue', kernel)}", flush=True)
    for kernel in K6F_KERNELS:
        print(f"{kernel}: {_build.ptxas_report('encoder_epilogue_train', kernel)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    enc = init_model(flagship_config(), seed=0, device=dev).pcl_net
    ws = [t.detach() for layer in (enc.conv3, enc.conv4) for t in (layer.weight, layer.bias)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def cloud(n, p):
        return torch.relu(torch.randn(n, p, 128, device=dev, generator=gen))

    with torch.no_grad():
        for p in (1024, 1000):
            x32 = cloud(8, p)
            for cdt in (torch.bfloat16, torch.float32):
                x = x32.to(cdt)
                out = enc_ops.dense_relu_dense_max(x, *ws, cdt)
                again = enc_ops.dense_relu_dense_max(x, *ws, cdt)
                plain = enc_ops.dense_relu_dense_max_twin(x, *ws, cdt)
                folded = enc_ops.dense_relu_dense_max_folded_twin(x, *ws, cdt)
                k6, _ = train_ops.dense_relu_dense_max_fwd(x, *ws, cdt)
                torch.cuda.synchronize()
                scale = max(1.0, plain.abs().max().item())
                print(f"{str(cdt)[6:]} N=8 P={p}: err vs plain {(out - plain).abs().max().item():.3e}, "
                      f"vs folded {(out - folded).abs().max().item():.3e} (limit "
                      f"{TOL[cdt] * scale:.3e}); mean |k - folded| {(out - folded).abs().mean().item():.3e}"
                      f", mean |plain - folded| {(plain - folded).abs().mean().item():.3e}; finite "
                      f"{bool(torch.isfinite(out).all())}, bit_equal {torch.equal(out, again)}; K6 fwd "
                      f"vs K1: {(k6 != out).float().mean().item():.4%} differ, at most "
                      f"{bf16_spacings(k6, out).max().item():.2f} bf16 spacings", flush=True)
    if args.train:
        train(dev, ws)
    if not args.time_batch:
        return
    x = cloud(2 * args.time_batch, 1024).bfloat16()
    bf = torch.bfloat16
    with torch.no_grad():
        ms = time_ms(lambda: enc_ops.dense_relu_dense_max(x, *ws, bf))
        k6_ms = time_ms(lambda: train_ops.dense_relu_dense_max_fwd(x, *ws, bf))
        print(f"K1 bf16 N={x.shape[0]}: {ms:.4f} ms; K6 fwd {k6_ms:.4f} ms", flush=True)
        if args.skip_w4:
            lib = ctypes.CDLL(str(_build.build("encoder_epilogue", (SKIP_W4,))))
            lib.catre_dense_relu_dense_max.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            w3p, w4p = (enc_ops.pack_panels(w.to(bf)) for w in (ws[0], ws[2]))
            b3, b4 = (b.to(bf).float() for b in (ws[1], ws[3]))
            out = torch.empty(x.shape[0], 1024, device=dev)
            stream = _build.stream_handle(dev)

            def diag():
                _build.check(lib.catre_dense_relu_dense_max(
                    x.data_ptr(), w3p.data_ptr(), b3.data_ptr(), w4p.data_ptr(), b4.data_ptr(),
                    out.data_ptr(), x.shape[0], 1024, 128, 512, 1024, 1, stream), "diagnostic K1")
            print(f"K1 without W4 loads (diagnostic, wrong result): {time_ms(diag):.4f} ms",
                  flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            enc_ops.dense_relu_dense_max(x, *ws, bf)
            torch.cuda.synchronize()
    for ev in sorted(prof.key_averages(), key=lambda ev: -ev.device_time_total)[:8]:
        if ev.device_time_total:
            print(f"  {ev.device_time_total / 1e3:9.4f} ms x{ev.count:3d}  {ev.key[:90]}", flush=True)
    w4_bytes = 2 * 512 * 1024 * x.shape[0] * 8         # W4 read from L2 once per 128-point tile
    print(f"W4 from L2: {w4_bytes / 1e9:.2f} GB a launch, {w4_bytes / ms / 1e9:.2f} TB/s at K1's time",
          flush=True)


def train(dev, ws):
    """The K6 forward's idx on exact-integer operands, then its time at the
    train step's 1024 clouds beside K1 and the diagnostic build."""
    gen = torch.Generator(device=dev).manual_seed(1)
    chid, cout = ws[0].shape[0], ws[2].shape[0]
    w_int = [torch.randint(lo, hi, shape, device=dev, generator=gen).float()
             for lo, hi, shape in ((-2, 3, (chid, 128)), (-8, 9, (chid,)), (-2, 3, (cout, chid)),
                                   (-8, 9, (cout,)))]
    with torch.no_grad():
        for p in (1024, 1000):
            x32 = torch.randint(0, 3, (8, p, 128), device=dev, generator=gen).float()
            for cdt in (torch.bfloat16, torch.float32):
                x = x32.to(cdt)
                out, idx = train_ops.dense_relu_dense_max_fwd(x, *w_int, cdt)
                out_p, idx_p = train_ops.dense_relu_dense_max_fwd_plain(x, *w_int, cdt)
                k1 = enc_ops.dense_relu_dense_max(x, *w_int, cdt)
                torch.cuda.synchronize()
                ok = torch.equal(idx, idx_p) and torch.equal(out, out_p) and torch.equal(out, k1)
                print(f"{'ok' if ok else 'FAIL'} K6 fwd {str(cdt)[6:]} integer operands N=8 P={p}: "
                      f"idx differs at {(idx != idx_p).sum().item()} of {idx.numel()}, out equal "
                      f"{torch.equal(out, out_p)}, out equal to K1 {torch.equal(out, k1)}", flush=True)
    bf = torch.bfloat16
    x = torch.relu(torch.randn(TRAIN_CLOUDS, 1024, 128, device=dev, generator=gen)).to(bf)
    lib = ctypes.CDLL(str(_build.build("encoder_epilogue_train", (BARE_FOLD,))))
    lib.catre_dense_relu_dense_max_train_fwd.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    w3p, w4p = (enc_ops.pack_panels(w.to(bf)) for w in (ws[0], ws[2]))
    b3, b4 = (b.to(bf).float() for b in (ws[1], ws[3]))
    out = torch.empty(TRAIN_CLOUDS, cout, device=dev)
    idx = torch.empty(TRAIN_CLOUDS, cout, device=dev, dtype=torch.int32)
    stream = _build.stream_handle(dev)

    def bare():
        _build.check(lib.catre_dense_relu_dense_max_train_fwd(
            x.data_ptr(), w3p.data_ptr(), b3.data_ptr(), w4p.data_ptr(), b4.data_ptr(),
            out.data_ptr(), idx.data_ptr(), TRAIN_CLOUDS, 1024, 128, chid, cout, 1, stream),
            "diagnostic K6 forward")

    with torch.no_grad():
        times = {"K1": lambda: enc_ops.dense_relu_dense_max(x, *ws, bf),
                 "K6 fwd": lambda: train_ops.dense_relu_dense_max_fwd(x, *ws, bf),
                 "K6 fwd, bare fold (diagnostic, idx = 0)": bare}
        line = ", ".join(f"{name} {time_ms(fn):.4f} ms" for name, fn in times.items())
    print(f"bf16 N={TRAIN_CLOUDS} P=1024: {line}", flush=True)


if __name__ == "__main__":
    main()
