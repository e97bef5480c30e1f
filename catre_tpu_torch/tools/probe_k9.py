"""Short card check of K9, the three fused encoder columns (`csrc/encoder_chain.cu`,
bf16 build `csrc/encoder_chain_wgmma.cuh`), after an edit of its sources.

    python -m catre_tpu_torch.tools.probe_k9 [--time-batch 256]

Builds `encoder_chain` and prints what ptxas says of its kernels (the main
design, the STN design at cin = 3 and 64, the f32 `gemm_tile` kernel:
registers, stack frame, spills, any warning), the card's name and power
limit, then one `ok` / `FAIL` line per (column, dtype, clouds, P): the
kernel against its plain version (f32 1e-4, bf16 3e-2 x max(1, max|plain|),
as chip_smoke.py), in bf16 nearer its plain version than the same layers
rounded as flax Dense, and four launches bit-equal. The point counts are the
refine's 1024, 900 and 136 (tiles of 128 that do not divide) and 40 (one
partial tile). With `--time-batch B` it times each column in bf16 at 2 B
clouds of 1024 points (CUDA events, 10 launches after 2) beside its plain
version, and K1 and K2 on the same clouds. Exits 1 on a FAIL.
"""

import argparse
import subprocess
import sys

import torch

from ..models.layers import Dense, dense
from ..ops import _build
from ..ops import encoder_chain as chain_ops
from ..ops import encoder_epilogue as enc_ops
from .probe_k1 import time_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
COLUMNS = {"stn3d": ((3, 64, 128, 1024), True), "stnkd": ((64, 64, 128, 1024), True),
           "main": ((64, 128, 512, 1024), False)}
KERNELS = ("chain3_main_wgmmaILi4E", "chain3_stn_wgmmaILi3E", "chain3_stn_wgmmaILi64E",
           "chain3_max_kernelIfE")
CASES = ((64, 1024), (16, 900), (16, 136), (24, 40))   # (clouds, P)
REPEATS = 4


def inputs(widths, n, p, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, p, widths[0], generator=gen)
    x = (x * 0.2 if widths[0] == 3 else torch.relu(x)).cuda()
    params = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        layer = Dense(cin, cout, gen)
        params += [layer.weight.detach().cuda(), layer.bias.detach().cuda()]
    return x, params


def check(column, n, p, cdt) -> bool:
    widths, relu_last = COLUMNS[column]
    x, params = inputs(widths, n, p)
    x = x.to(cdt)
    out = chain_ops.chain3_max(x, *params, cdt, relu_last=relu_last)
    ref = chain_ops.chain3_max_twin(x, *params, cdt, relu_last=relu_last)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    limit = TOL[cdt] * max(1.0, ref.abs().max().item())
    ok = bool(torch.isfinite(out).all()) and out.shape == ref.shape and err <= limit
    extra = ""
    if cdt == torch.bfloat16:
        h = dense(dense(x, *params[0:2], cdt, act=True), *params[2:4], cdt, act=True)
        flax = dense(h, *params[4:6], cdt, act=relu_last).amax(dim=1).float()
        near, gap = (out - ref).abs().mean().item(), (ref - flax).abs().mean().item()
        ok &= near <= 0.25 * gap
        same = all(torch.equal(out, chain_ops.chain3_max(x, *params, cdt, relu_last=relu_last))
                   for _ in range(REPEATS - 1))
        ok &= same
        extra = f", mean |kernel - plain| {near:.3e} vs flax-rounded {gap:.3e}, " \
                f"{REPEATS} launches bit-equal {same}"
    print(f"{'ok' if ok else 'FAIL'} {column} {str(cdt)[6:]} N={n} P={p}: max_abs_err {err:.3e} "
          f"(limit {limit:.3e}){extra}", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time the three columns in bf16 at 2 x this many clouds")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.build_all(("encoder_chain", "encoder_epilogue"))
    for line in _build.build_log("encoder_chain").splitlines():
        if "warning" in line.lower() or "error" in line.lower():
            print(line.strip(), flush=True)
    for kernel in KERNELS:
        print(f"{kernel}: {_build.ptxas_report('encoder_chain', kernel)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    ok = True
    with torch.no_grad():
        for column in COLUMNS:
            for cdt in (torch.float32, torch.bfloat16):
                for case in CASES:
                    ok &= check(column, *case, cdt)
        if args.time_batch:
            n = 2 * args.time_batch
            line = {}
            for column, (widths, relu_last) in COLUMNS.items():
                x, params = inputs(widths, n, 1024)
                x = x.bfloat16()
                line[column] = time_ms(lambda: chain_ops.chain3_max(
                    x, *params, torch.bfloat16, relu_last=relu_last))
                line[f"{column} plain"] = time_ms(lambda: chain_ops.chain3_max_twin(
                    x, *params, torch.bfloat16, relu_last=relu_last))
            x, params = inputs((128, 512, 1024), n, 1024)
            x = x.bfloat16()
            line["K1"] = time_ms(lambda: enc_ops.dense_relu_dense_max(x, *params, torch.bfloat16))
            _, params = inputs((128, 1024), 1, 1)
            line["K2"] = time_ms(lambda: enc_ops.dense_relu_max(x, *params, torch.bfloat16))
            print(f"bf16 {n} clouds x 1024 points, ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in line.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
