"""Short card check of K5's bf16 backward (`csrc/encoder_stn_tail_bwd.cuh`)
after an edit of its sources.

    python -m catre_tpu_torch.tools.probe_k5b [--time-batch 512] [--diagnostics] [--step-inputs]

Builds `encoder_epilogue_train` and prints what ptxas says of the bf16
build's kernels (the gate pass at cin = 128 and 64, the routing pass, the dx
pass: registers, stack frame, spills, any warning), each pass's dynamic
shared memory, the card's name and power limit, then one `ok` / `FAIL` line
per (dtype, N = 1, 3, 8 clouds, P = 1024, 1000, 40 points, and P = 200 with
every point twice and a quarter of the gates closed on every row): the error
of dx, dW and db against both plain versions (`dense_relu_max_bwd_plain`, and
`dense_relu_max_bwd_critical_plain` in the kernel's own order), dx's dtype,
dx zero on every row that no live channel points at, and whether four
launches give the same bits. With `--time-batch B` it times the bf16
backward at 2 B clouds of 1024 points (CUDA events, 10 launches after 2),
prints the critical rows, the live keys and the bound, splits one launch by
device kernel under `torch.profiler` (gate pass, the two `sum_rows`, routing
pass, dx pass) and prints the allocation beyond the outputs. `--diagnostics`
also times two diagnostic builds (wrong results): `CATRE_K5B_DX_ZEROS`, whose
dx pass stores zeros on every row (the store stream alone: no map, no sums),
and `CATRE_K5B_GATE_ROW0`, whose gate pass reads row 0 of each cloud for
every channel (no scattered x traffic). `--step-inputs` also times it on the
x, idx and d_out of one K5 backward captured from a flagship train step at
batch B (`capture_step_inputs`).
"""

import argparse
import concurrent.futures
import ctypes
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..entry import flagship_config, flagship_trainer
from ..models.catre import init_model
from ..ops import _build
from ..ops import encoder_epilogue_train as train_ops
from .probe_k1 import time_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
KERNELS = ("gate_passILi8E", "gate_passILi4E", "route_clouds", "dx_passE")   # as ptxas names them
DIAGNOSTICS = {"CATRE_K5B_DX_ZEROS": "the dx pass storing zeros only (no map, no sums)",
               "CATRE_K5B_GATE_ROW0": "the gate pass reading row 0 for every channel"}
NAMES = ("dx", "dW", "db")
REPEATS = 4
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def bind(path):
    lib = ctypes.CDLL(str(path))
    lib.catre_dense_relu_max_train_bwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.catre_dense_relu_max_train_bwd.restype = ctypes.c_int
    lib.catre_k6_route_stride.argtypes = [ctypes.c_int]
    lib.catre_k6_route_stride.restype = ctypes.c_int
    return lib


def case(ws, gen, n, p, cdt, ties=False):
    """x (n, p, cin) in cdt, weights with every fourth gate closed on every row
    (bias -50: idx 0, d 0), idx from the K5 forward, d_out (n, cout) f32 with
    every sixth channel zero; `ties`: every point twice."""
    w, b = ws[0], ws[1].clone()
    b[::4] = -50.0
    x = torch.relu(torch.randn(n, p, w.shape[1], device="cuda", generator=gen))
    if ties:
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    x = x.to(cdt)
    with torch.no_grad():
        _, idx = train_ops.dense_relu_max_fwd(x, w, b, cdt)
    d_out = torch.randn(n, w.shape[0], device="cuda", generator=gen)
    d_out[:, ::6] = 0.0
    return x, [w, b], idx, d_out


def live_rows(x, ws, idx, d_out):
    """(N, P) rows that a live channel points at, counting as live every
    channel whose gate is within a rounding of flipping (the kernel sums its
    f32 dot in another order than the plain version)."""
    n, p, cin = x.shape
    rows = torch.gather(x.float(), 1, idx.long()[:, :, None].expand(-1, -1, cin))
    pre = (rows * ws[0].to(x.dtype).float()).sum(dim=2) + ws[1]
    near = pre.abs() <= 1e-4 * max(1.0, pre.abs().max().item())
    live = ((pre > 0) | near) & (d_out.to(x.dtype) != 0)
    hit = torch.zeros(n, p, dtype=torch.bool, device=x.device)
    hit[torch.arange(n, device=x.device)[:, None].expand_as(idx)[live], idx.long()[live]] = True
    return hit


def bound(x, idx, d_out):
    """-> (critical rows, live keys, bound ms, bound_by) of the function on
    these inputs: the argmax rows of x read once, dx written once in x's
    dtype, d_out, idx, W and the f32 gradients; three length-cin f32 products
    per (cloud, channel)."""
    n, p, cin = x.shape
    cout = idx.shape[1]
    crit = (idx.long() + torch.arange(n, device=idx.device)[:, None] * p).unique().numel()
    live = int((d_out.to(x.dtype) != 0).sum().item())
    nbytes = (x.element_size() * (crit * cin + n * p * cin) + 8 * n * cout + 2 * cout * cin
              + 4 * cout * (cin + 1))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 3 * 2 * n * cout * cin / PEAK_F32 * 1e3
    return crit, live, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def capture_step_inputs(batch):
    """The (x, w, b, idx, d_out) of the first K5 backward of one flagship train
    step at `batch` objects (bf16, the shipped flags), copied as the step
    handed them to `dense_relu_max_bwd`."""
    t = flagship_trainer("cuda", batch_size=batch, seed=0)
    seen, launch = [], train_ops.dense_relu_max_bwd

    def grab(x, w, b, idx, d_out, cdt):
        if not seen:
            seen.append(tuple(a.clone() for a in (x, w, b, idx, d_out)))
        return launch(x, w, b, idx, d_out, cdt)

    train_ops.dense_relu_max_bwd = grab
    try:
        t.step(t.state, t.batch, t.generator, t.lr)
    finally:
        train_ops.dense_relu_max_bwd = launch
    torch.cuda.synchronize()
    return seen[0]


def split_by_kernel(fn, top=8):
    """One call of `fn` under torch.profiler: its device kernels by time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for ev in sorted(prof.key_averages(), key=lambda ev: -ev.device_time_total)[:top]:
        if ev.device_time_total:
            print(f"  {ev.device_time_total / 1e3:9.4f} ms x{ev.count:3d}  {ev.key[:90]}", flush=True)


def timed(tag, x, ws, idx, d_out):
    bf = torch.bfloat16
    crit, live, bnd, by = bound(x, idx, d_out)
    with torch.no_grad():
        ms = time_ms(lambda: train_ops.dense_relu_max_bwd(x, *ws, idx, d_out, bf))
    n = x.shape[0]
    print(f"K5 bwd bf16 {tag} N={n} P={x.shape[1]}: {ms:.4f} ms; {crit} critical rows "
          f"({crit / n:.1f} a cloud), {live} live cotangents ({live / n:.1f} a cloud); bound "
          f"{bnd:.4f} ms ({by}, {bnd / ms:.1%})", flush=True)
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time the bf16 kernel at 2 x this many clouds of 1024 points")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also time the diagnostic builds")
    ap.add_argument("--step-inputs", action="store_true",
                    help="also time it on inputs captured from a train step at that batch")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(("encoder_epilogue_train",))
    for line in _build.build_log("encoder_epilogue_train").splitlines():
        if "warning" in line.lower():
            print(line.strip(), flush=True)
    lib = train_ops._lib()
    for kernel in KERNELS:
        print(f"{kernel}: {_build.ptxas_report('encoder_epilogue_train', kernel)}", flush=True)
    print(f"dynamic shared memory at 128 -> 1024: gate pass {lib.catre_k5_bwd_smem(128, 1024, 0)}, "
          f"dx pass {lib.catre_k5_bwd_smem(128, 1024, 1)} bytes", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    enc = init_model(flagship_config(), seed=0, device=torch.device("cuda")).pcl_net
    ws = [enc.stn.conv3.weight.detach(), enc.stn.conv3.bias.detach()]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    shapes = [(n, p, False) for p in (1024, 1000, 40) for n in (1, 3, 8)] + [(6, 200, True)]
    with torch.no_grad():
        for n, p, ties in shapes:
            for cdt in (torch.bfloat16, torch.float32):
                x, wb, idx, d_out = case(ws, gen, n, p, cdt, ties)
                runs = [train_ops.dense_relu_max_bwd(x, *wb, idx, d_out, cdt) for _ in range(REPEATS)]
                outs = runs[0]
                plain = train_ops.dense_relu_max_bwd_plain(x, *wb, idx, d_out, cdt)
                crit = train_ops.dense_relu_max_bwd_critical_plain(x, *wb, idx, d_out, cdt)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(outs, r))
                finite = all(bool(torch.isfinite(o).all()) for o in outs)
                off = outs[0][~live_rows(x, wb, idx, d_out)]
                zero = off.numel() == 0 or off.abs().max().item() == 0
                ok, parts = same and finite and zero and outs[0].dtype == cdt, []
                for name, o, rp, rc in zip(NAMES, outs, plain, crit):
                    ep = (o.float() - rp.float()).abs().max().item()
                    ec = (o.float() - rc.float()).abs().max().item()
                    limit = TOL[cdt] * max(1.0, rp.abs().max().item(), rc.abs().max().item())
                    ok = ok and ep <= limit and ec <= limit
                    parts.append(f"{name} {ep:.2e}/{ec:.2e}")
                if ties:
                    lowest = outs[0][:, p // 2:].abs().max().item() == 0
                    ok = ok and lowest
                    parts.append(f"dx zero past the lowest tied rows {lowest}")
                bad += not ok
                print(f"{'ok  ' if ok else 'FAIL'} {str(cdt)[6:]} N={n} P={p}{' ties' if ties else ''}"
                      f": err vs plain / vs critical plain: {', '.join(parts)}; dx "
                      f"{str(outs[0].dtype)[6:]}, zero off the live rows {zero}, finite {finite}, "
                      f"{REPEATS} launches bit_equal {same}", flush=True)
    if bad:
        print(f"probe_k5b: {bad} case(s) FAIL", flush=True)
    if not args.time_batch:
        return
    bf = torch.bfloat16
    x = torch.relu(torch.randn(2 * args.time_batch, 1024, 128, device="cuda", generator=gen)).to(bf)
    with torch.no_grad():
        _, idx = train_ops.dense_relu_max_fwd(x, *ws, bf)
    d_out = torch.randn(x.shape[0], ws[0].shape[0], device="cuda", generator=gen)
    ms = timed("random operands", x, ws, idx, d_out)
    with torch.no_grad():
        if args.diagnostics:
            with concurrent.futures.ThreadPoolExecutor(max_workers=len(DIAGNOSTICS)) as pool:
                libs = dict(zip(DIAGNOSTICS, pool.map(
                    lambda d: bind(_build.build("encoder_epilogue_train", (d,))), DIAGNOSTICS)))
            for macro, what in DIAGNOSTICS.items():
                diag_ms = time_ms(lambda: train_ops.k5_bwd_launch(libs[macro], x, *ws, idx, d_out, bf))
                print(f"K5 bwd with {what} ({macro}, wrong result): {diag_ms:.4f} ms, "
                      f"{(ms - diag_ms) / ms:.1%} below K5 bwd", flush=True)
                split_by_kernel(lambda: train_ops.k5_bwd_launch(libs[macro], x, *ws, idx, d_out, bf))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs = train_ops.dense_relu_max_bwd(x, *ws, idx, d_out, bf)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base
                 - sum(o.numel() * o.element_size() for o in outs))
        print(f"peak allocation beyond the outputs {extra / 2**20:.1f} MiB (N P cin 2 = "
              f"{x.numel() * 2 / 2**20:.0f} MiB)", flush=True)
        print("split of one launch by device kernel:", flush=True)
        split_by_kernel(lambda: train_ops.dense_relu_max_bwd(x, *ws, idx, d_out, bf))
    del x, idx, d_out, outs
    if args.step_inputs:
        xs, w, b, idx, d_out = capture_step_inputs(args.time_batch)
        timed(f"inputs of a train step at B={args.time_batch}", xs, [w, b], idx, d_out)
        with torch.no_grad():
            split_by_kernel(lambda: train_ops.dense_relu_max_bwd(xs, w, b, idx, d_out, bf))


if __name__ == "__main__":
    main()
