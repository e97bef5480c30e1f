"""Short card check of K4 (`csrc/rot_head_bwd.cu`) after an edit of its sources.

    python -m catre_tpu_torch.tools.probe_k4 [--batch 8] [--time-batch 512]

Builds the one library and prints what ptxas says of it (registers, spills),
the card's name and power limit, the transposed tensor-core products alone on
canned operands (`wgmma_tn`), then the kernel against its plain version per
gradient tensor at `--batch` objects, bf16 and f32, at 2048 points and at 1999
with 1000 cloud points (a tile the 64-point tile does not fill, the cloud /
keypoint boundary inside a tile), and whether a second launch gives the same
bits. With `--time-batch B` it times the bf16 kernel at B objects (CUDA
events, 5 launches after 2) and splits one launch by device kernel under
`torch.profiler`. About 40 s on an H100, against `chip_smoke.py`'s 70.
"""

import argparse
import copy
import dataclasses
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..entry import flagship_config
from ..models.catre import init_model
from ..ops import _build
from ..ops import rot_head as rot_ops
from ..ops import rot_head_train as train_ops

RAGGED = (1999, 1000)     # points, cloud points


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time the bf16 kernel at this batch")
    args = ap.parse_args()
    dev = torch.device("cuda")
    _build.load("rot_head_bwd")
    for line in _build.build_log("rot_head_bwd").splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    gen = torch.Generator(device=dev).manual_seed(3)
    x, w0, w1 = (torch.randn(*s, device=dev, generator=gen).bfloat16()
                 for s in ((64, 256), (256, 64), (256, 256)))
    outs, refs = train_ops.wgmma_tn(x, w0, w1), train_ops.wgmma_tn_plain(x, w0, w1)
    torch.cuda.synchronize()
    for name, o, r in zip(("x @ w1", "x @ w0", "x[:, :64] @ w0^T"), outs, refs):
        print(f"wgmma_tn {name}: max_abs_err={(o - r).abs().max().item():.3e} "
              f"max|plain|={r.abs().max().item():.3e}", flush=True)

    head = copy.deepcopy(init_model(flagship_config(), seed=0, device=dev).rot_head)
    with torch.no_grad():
        for prm in head.parameters():
            prm.mul_(50.0)                       # signal well above the 1e-3 init
    n_pts = head.rot_head_x.point_weight.shape[0]

    def make(cdt, b, p=n_pts, n_pcl=n_pts // 2):
        with torch.no_grad():
            pack = rot_ops.pack_rot_head(head, cdt, weight_dtype=torch.float32)
            pack = dataclasses.replace(pack, pw=pack.pw[:, :p].contiguous())
            pf = torch.randn(b, p, 64, device=dev, generator=gen) * 0.5
            g2 = torch.randn(b, 2, 1024, device=dev, generator=gen) * 0.5
            d_out = torch.randn(b, 6, device=dev, generator=gen)
            return pf.to(cdt), (g2 @ pack.w_g.T).contiguous(), pack, n_pcl, d_out

    for cdt in (torch.bfloat16, torch.float32):
        for p, n_pcl in ((n_pts, n_pts // 2), RAGGED):
            a = make(cdt, args.batch, p, n_pcl)
            ref = train_ops.rot_head_bwd_twin(*a)
            with torch.no_grad():
                out = train_ops.rot_head_bwd(*a)
                again = train_ops.rot_head_bwd(*a)
            torch.cuda.synchronize()
            for n in train_ops.GRAD_NAMES:
                err = (out[n] - ref[n]).abs().max().item()
                scale = max(1.0, ref[n].abs().max().item())
                print(f"{str(cdt)[6:]} P={p} d_{n}: err={err:.3e} err/max(1,max|plain|)="
                      f"{err / scale:.3e} finite={bool(torch.isfinite(out[n]).all())} "
                      f"bit_equal={torch.equal(out[n], again[n])}", flush=True)
    if not args.time_batch:
        return
    a = make(torch.bfloat16, args.time_batch)
    with torch.no_grad():
        for _ in range(2):
            train_ops.rot_head_bwd(*a)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            train_ops.rot_head_bwd(*a)
        end.record()
        torch.cuda.synchronize()
        print(f"K4 bf16 B={args.time_batch}: {start.elapsed_time(end) / 5:.4f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_ops.rot_head_bwd(*a)
            torch.cuda.synchronize()
    for ev in sorted(prof.key_averages(), key=lambda ev: -ev.device_time_total)[:6]:
        if ev.device_time_total:
            print(f"  {ev.device_time_total / 1e3:9.4f} ms x{ev.count:3d}  {ev.key[:90]}", flush=True)


if __name__ == "__main__":
    main()
