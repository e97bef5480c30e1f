"""Short card check of K7/K8, K3's bf16 kernel with G objects per block and the
rounded point reduction (`csrc/rot_head.cu`), after an edit of its sources.

    python -m catre_tpu_torch.tools.probe_k8 [--time-batch 256]

Builds `rot_head` and prints what ptxas says of K3's and K7/K8's
instantiations (registers, stack frame, spills, any warning), the card's
name and power limit, then one `ok` / `FAIL` line per (dtype, B, P, n_pcl):
K7 and K8 at G = 2, 4 and 8 objects per block against their plain version
(`rot_head_multi_twin`), K7 equal to K8, in f32 bit-equal to K3, in bf16
bit-equal across G, nearer their own plain version than K3's, and four
launches bit-equal. The point counts are the refine's 2048 (32 tiles of 64
points an object, 96 a block's sequence per object), 900 (15 tiles, 45 an
object: the ring's stage and phase no longer line up at object boundaries),
136 (3 tiles, 9 an object) and 40 (one partial tile). With `--time-batch B`
it times K3 and K8 at each G on B objects of 2048 points in bf16 (CUDA
events, 10 launches after 2) beside the plain version; `--no-round` also
times a diagnostic build of K8 without the rounded point reduction
(`CATRE_K8_NO_ROUND`: K3's function with G objects per block, what the
rounding costs). Exits 1 on a FAIL.
"""

import argparse
import ctypes
import subprocess
import sys

import torch

from ..models.heads import ConvOutPerRotHead
from ..ops import _build
from ..ops import rot_head as rot_ops
from ..ops import rot_head_multi as multi_ops
from .probe_k1 import time_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}     # x max(1, max|plain|), as chip_smoke.py
K3_KERNEL = "rot_head_wgmma_kernelILi1ELb0E"
MULTI_KERNELS = tuple(f"rot_head_wgmma_kernelILi{g}ELb1E" for g in multi_ops.OBJECTS_PER_BLOCK)
CASES = ((8, 2048, 1024), (8, 900, 450), (8, 136, 68), (16, 40, 20))   # (B, P, n_pcl)
REPEATS = 4
NO_ROUND = "CATRE_K8_NO_ROUND"


def inputs(B, P, n_pcl, cdt, seed=0):
    gen = torch.Generator().manual_seed(seed)
    head = ConvOutPerRotHead(gen, num_points=P)
    with torch.no_grad():
        for prm in head.parameters():
            prm.mul_(50.0)     # signal well above the 1e-3 init
    head = head.cuda()
    pf = (torch.randn(B, P, 64, generator=gen) * 0.5).cuda()
    g2 = (torch.randn(B, 2, 1024, generator=gen) * 0.5).cuda()
    pack = rot_ops.pack_rot_head(head, cdt)
    return pf.to(cdt), (g2 @ pack.w_g.T).contiguous(), pack, n_pcl


def check(B, P, n_pcl, cdt) -> bool:
    args = inputs(B, P, n_pcl, cdt)
    ref, k3_plain = multi_ops.rot_head_multi_twin(*args), rot_ops.rot_head_twin(*args)
    k3 = rot_ops.rot_head(*args)
    limit = TOL[cdt] * max(1.0, ref.abs().max().item())
    outs, worst, ok = {}, 0.0, True
    for g in multi_ops.OBJECTS_PER_BLOCK:
        if B % g:
            continue
        k7 = multi_ops.rot_head_grouped(*args, g)
        k8 = multi_ops.rot_head_blocked(*args, g)
        torch.cuda.synchronize()
        outs[g] = k8
        err = (k8 - ref).abs().max().item()
        worst = max(worst, err)
        ok &= bool(torch.isfinite(k8).all()) and err <= limit and torch.equal(k7, k8)
        if cdt == torch.float32:
            ok &= torch.equal(k8, k3)
        else:
            near, gap = (k8 - ref).abs().mean().item(), (ref - k3_plain).abs().mean().item()
            ok &= near <= 0.25 * gap
        ok &= all(torch.equal(k8, multi_ops.rot_head_blocked(*args, g)) for _ in range(REPEATS - 1))
    same = all(torch.equal(o, outs[min(outs)]) for o in outs.values())
    if cdt == torch.bfloat16:
        ok &= same
    print(f"{'ok' if ok else 'FAIL'} {str(cdt)[6:]} B={B} P={P} n_pcl={n_pcl}: max_abs_err "
          f"{worst:.3e} (limit {limit:.3e}), K3 vs plain {(k3 - k3_plain).abs().max().item():.3e}, "
          f"G {sorted(outs)} bit-equal {same}", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-batch", type=int, default=0,
                    help="also time K3 and K8 in bf16 at this many objects of 2048 points")
    ap.add_argument("--no-round", action="store_true",
                    help="with --time-batch, also time K8 built without the rounded reduction")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.no_round:
        _build.build("rot_head", (NO_ROUND,))
    _build.build_all(("rot_head",))
    for line in _build.build_log("rot_head").splitlines():
        if "warning" in line.lower():
            print(line.strip(), flush=True)
    for kernel in (K3_KERNEL, *MULTI_KERNELS):
        print(f"{kernel}: {_build.ptxas_report('rot_head', kernel)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    ok = True
    with torch.no_grad():
        for cdt in (torch.float32, torch.bfloat16):
            for case in CASES:
                ok &= check(*case, cdt)
        if args.time_batch:
            B = args.time_batch
            targs = inputs(B, 2048, 1024, torch.bfloat16)
            line = {"K3": time_ms(lambda: rot_ops.rot_head(*targs))}
            for g in multi_ops.OBJECTS_PER_BLOCK:
                line[f"K8 G={g}"] = time_ms(lambda: multi_ops.rot_head_blocked(*targs, g))
            if args.no_round:
                lib = ctypes.CDLL(str(_build.library_path("rot_head", (NO_ROUND,))))
                lib.catre_rot_head_multi.argtypes = multi_ops._lib().catre_rot_head_multi.argtypes
                pf, gterm, pack, n_pcl = targs
                ptrs = [t.data_ptr() for t in (pf, gterm, pack.w_pt, pack.b0, pack.gn0s, pack.gn0b,
                                               pack.w1, pack.b1, pack.gn1s, pack.gn1b, pack.pw,
                                               pack.neck, pack.bias6)]
                out = torch.empty(B, 6, device="cuda")
                stream = _build.stream_handle(out.device)
                for g in multi_ops.OBJECTS_PER_BLOCK:
                    def launch(g=g):
                        _build.check(lib.catre_rot_head_multi(*ptrs, out.data_ptr(), B, 2048,
                                                              n_pcl, g, 1, stream), NO_ROUND)
                    line[f"K8 G={g} {NO_ROUND}"] = time_ms(launch)
            line["plain"] = time_ms(lambda: multi_ops.rot_head_multi_twin(*targs))
            print(f"bf16 B={B} x 2048 points, ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in line.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
