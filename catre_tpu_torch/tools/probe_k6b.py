"""Short card check of K6's bf16 backward (`csrc/encoder_tail_bwd_wgmma.cuh`)
after an edit of its sources.

    python -m catre_tpu_torch.tools.probe_k6b [--time-batch 512] [--skip-w4]

Builds `encoder_epilogue_train` and prints what ptxas says of the bf16
build's kernels (the routing pass and the three `wgmma` passes: registers,
stack frame, spills, any warning or note of `wgmma` serialisation), each pass's dynamic shared memory, the
card's name and power limit, then one `ok` / `FAIL` line per (dtype, N = 1,
3, 8 clouds, P = 1024, 1000, 40 points, and P = 200 with every point twice,
the tied-rows case): the error of each output tensor (dx, dW3, db3, dW4, db4)
against both plain versions (`dense_relu_dense_max_bwd_plain`, and
`dense_relu_dense_max_bwd_critical_plain` in the kernel's own order), and
whether four launches give the same bits. With `--time-batch B` it times
the bf16 backward at 2 B clouds of 1024 points (CUDA events, 10 launches
after 2), prints the critical rows and the bound, and splits one launch by
device kernel under `torch.profiler`. `--skip-w4` also times a diagnostic
build (`CATRE_K6B_SKIP_W4_GATHER`) that builds g from a constant instead of
the W4 rows in L2: a wrong result, the time without g's L2 traffic.
`--phases` runs one launch of a diagnostic build (`CATRE_K6B_PHASE_CLOCKS`)
in which thread 0 of every block adds up the SM clocks of each phase of its
pass, and prints them per block: where a pass spends its time.
"""

import argparse
import concurrent.futures
import ctypes
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..entry import flagship_config
from ..models.catre import init_model
from ..ops import _build
from ..ops import encoder_epilogue_train as train_ops
from .probe_k1 import time_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
KERNELS = ("route_clouds", "cloud_passILi8E", "dw3_passILi8E", "dw4_passILi8E")   # at cin = 128
SKIP_W4 = "CATRE_K6B_SKIP_W4_GATHER"
PHASE_CLOCKS = "CATRE_K6B_PHASE_CLOCKS"
# tailbwd::Phase, as each pass uses its marks
PHASES = {
    "cloud pass": ("route staged", "dx gaps zeroed", "x gather issued", "g built",
                   "x landed (barrier)", "h3p issued", "products waited", "gate, dx issued",
                   "dx stored (barrier)", "cloud end (barrier)"),
    "dW3 pass": ("route staged", "db3 sums", "x gather issued", "g built", "x landed (barrier)",
                 "h3p", "d_h3^T x", "gate (barrier)", "tile end (barrier)", "cloud end (barrier)"),
    "dW4 pass": ("-", "-", "next x gather and d4 issued", "-", "x landed (barrier)", "-", "h3p",
                 "epilogue", "tile end (barrier)", "-"),
}
NAMES = ("dx", "dW3", "db3", "dW4", "db4")
REPEATS = 4
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def bind(path):
    lib = ctypes.CDLL(str(path))
    lib.catre_dense_relu_dense_max_train_bwd.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.catre_dense_relu_dense_max_train_bwd.restype = ctypes.c_int
    return lib


def case(ws, gen, n, p, cdt, ties=False):
    """x (n, p, 128) in cdt, idx from the K6 forward, d_out (n, cout) f32."""
    x = torch.relu(torch.randn(n, p, 128, device="cuda", generator=gen))
    if ties:
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    x = x.to(cdt)
    with torch.no_grad():
        _, idx = train_ops.dense_relu_dense_max_fwd(x, *ws, cdt)
    d_out = torch.randn(n, ws[2].shape[0], device="cuda", generator=gen)
    return x, idx, d_out


def scale(r):
    return max(1.0, r.abs().max().item())


def print_phases(lib, x, ws, idx, d_out, n_clouds, chid, cout):
    """One launch of the clock-marked build; each pass's clocks per block by phase."""
    lib.catre_k6b_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.catre_k6b_phase_clocks.restype = ctypes.c_int
    clocks = (ctypes.c_ulonglong * (3 * len(PHASES["cloud pass"])))()
    train_ops.k6_bwd_launch(lib, x, ws[0], ws[1], ws[2], idx, d_out, torch.bfloat16)
    torch.cuda.synchronize()
    _build.check(lib.catre_k6b_phase_clocks(clocks), "catre_k6b_phase_clocks")     # zero them
    train_ops.k6_bwd_launch(lib, x, ws[0], ws[1], ws[2], idx, d_out, torch.bfloat16)
    torch.cuda.synchronize()
    _build.check(lib.catre_k6b_phase_clocks(clocks), "catre_k6b_phase_clocks")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid, g3, g4 = train_ops.k6_bwd_schedule(n_clouds, chid, cout, sms)
    blocks = (grid, g3 * (chid // 64), g4 * (chid // 128) * (cout // 128))
    k = len(PHASES["cloud pass"])
    for i, (name, labels) in enumerate(PHASES.items()):
        per_block = [clocks[i * k + j] / blocks[i] for j in range(k)]
        total = sum(per_block) or 1.0
        parts = ", ".join(f"{lab} {c:.0f} ({c / total:.0%})" for lab, c in zip(labels, per_block)
                          if c)
        print(f"{name}, SM clocks per block of thread 0 ({blocks[i]} blocks): total {total:.0f}; "
              f"{parts}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time the bf16 kernel at 2 x this many clouds of 1024 points")
    ap.add_argument("--skip-w4", action="store_true",
                    help="also time the diagnostic build that builds g without W4 loads")
    ap.add_argument("--phases", action="store_true",
                    help="also split each pass by phase (diagnostic build with clock marks)")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(("encoder_epilogue_train",))
    for line in _build.build_log("encoder_epilogue_train").splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            print(line.strip(), flush=True)
    lib = train_ops._lib()
    for kernel in KERNELS:
        print(f"{kernel}: {_build.ptxas_report('encoder_epilogue_train', kernel)}", flush=True)
    smem = [lib.catre_k6_bwd_smem(128, 512, 1024, i) for i in range(3)]
    print(f"dynamic shared memory at 128 -> 512 -> 1024: cloud pass {smem[0]}, dW3 pass "
          f"{smem[1]}, dW4 pass {smem[2]} bytes", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    enc = init_model(flagship_config(), seed=0, device=torch.device("cuda")).pcl_net
    ws = [t.detach() for layer in (enc.conv3, enc.conv4) for t in (layer.weight, layer.bias)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    shapes = [(n, p, False) for p in (1024, 1000, 40) for n in (1, 3, 8)] + [(6, 200, True)]
    with torch.no_grad():
        for n, p, ties in shapes:
            for cdt in (torch.bfloat16, torch.float32):
                x, idx, d_out = case(ws, gen, n, p, cdt, ties)
                runs = [train_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, cdt)
                        for _ in range(REPEATS)]
                outs = runs[0]
                plain = train_ops.dense_relu_dense_max_bwd_plain(x, *ws, idx, d_out, cdt)
                crit = train_ops.dense_relu_dense_max_bwd_critical_plain(x, *ws, idx, d_out, cdt)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(outs, r))
                finite = all(bool(torch.isfinite(o).all()) for o in outs)
                ok, parts = same and finite, []
                for name, o, rp, rc in zip(NAMES, outs, plain, crit):
                    ep, ec = (o - rp).abs().max().item(), (o - rc).abs().max().item()
                    limit = TOL[cdt] * max(scale(rp), scale(rc))
                    ok = ok and ep <= limit and ec <= limit
                    parts.append(f"{name} {ep:.2e}/{ec:.2e}")
                if ties:
                    lowest = outs[0][:, p // 2:].abs().max().item() == 0
                    ok = ok and lowest
                    parts.append(f"dx zero past the lowest tied rows {lowest}")
                bad += not ok
                print(f"{'ok  ' if ok else 'FAIL'} {str(cdt)[6:]} N={n} P={p}{' ties' if ties else ''}"
                      f": err vs plain / vs critical plain: {', '.join(parts)}; finite {finite}, "
                      f"{REPEATS} launches bit_equal {same}", flush=True)
    if bad:
        print(f"probe_k6b: {bad} case(s) FAIL", flush=True)
    if not args.time_batch:
        return
    bf = torch.bfloat16
    n_clouds, n_pts = 2 * args.time_batch, 1024
    x, idx, d_out = case(ws, gen, n_clouds, n_pts, bf)
    chid, cout = ws[0].shape[0], ws[2].shape[0]
    crit = (idx.long() + torch.arange(n_clouds, device="cuda")[:, None] * n_pts).unique().numel()
    flops = 2 * (3 * crit * 128 * chid + 2 * n_clouds * cout * chid)
    nbytes = 2 * crit * 128 + 4 * n_clouds * n_pts * 128 + 8 * n_clouds * cout
    bound = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    with torch.no_grad():
        ms = time_ms(lambda: train_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, bf))
        print(f"K6 bwd bf16 N={n_clouds} P={n_pts}: {ms:.4f} ms; {crit} critical rows "
              f"({crit / n_clouds:.1f} a cloud); bound {bound:.4f} ms ({bound / ms:.1%})", flush=True)
        wanted = [d for d, on in ((SKIP_W4, args.skip_w4), (PHASE_CLOCKS, args.phases)) if on]
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            diag = dict(zip(wanted, pool.map(
                lambda d: bind(_build.build("encoder_epilogue_train", (d,))), wanted)))
        if args.skip_w4:
            diag_ms = time_ms(lambda: train_ops.k6_bwd_launch(diag[SKIP_W4], x, ws[0], ws[1],
                                                              ws[2], idx, d_out, bf))
            print(f"K6 bwd with g from a constant, no W4 loads (diagnostic, wrong result): "
                  f"{diag_ms:.4f} ms, {(ms - diag_ms) / ms:.1%} below K6 bwd", flush=True)
        if args.phases:
            print_phases(diag[PHASE_CLOCKS], x, ws, idx, d_out, n_clouds, chid, cout)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            outs = train_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, bf)
            torch.cuda.synchronize()
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        extra = torch.cuda.max_memory_allocated() - base - out_bytes
        print(f"peak allocation beyond the outputs {extra / 2**20:.1f} MiB "
              f"(N P chid 2 = {n_clouds * n_pts * chid * 2 / 2**20:.0f} MiB)", flush=True)
    for ev in sorted(prof.key_averages(), key=lambda ev: -ev.device_time_total)[:10]:
        if ev.device_time_total:
            print(f"  {ev.device_time_total / 1e3:9.4f} ms x{ev.count:3d}  {ev.key[:90]}", flush=True)


if __name__ == "__main__":
    main()
