"""Both rotation heads in one pass per object: kernel K3.

Counterpart of `catre_tpu/ops/pallas_heads.py::fused_conv_per_rot_head`
(:276), `group=1` path. `fused_conv_per_rot_head` packs the two per-axis
`RotHead`s of a `ConvOutPerRotHead` into joint 512-channel blocks
(`pack_rot_head`, as `pallas_heads.py:294-322` does), computes the
per-object global terms `gterm = [g_pcl; g_kps] @ W_g^T` (B, 2, 512) outside
the kernel (:326-329), and calls `rot_head`, which runs the plain twin for a
CPU tensor and launches `csrc/rot_head.cu` for a CUDA tensor, never falling
back.

The kernel hard-codes the flagship widths: 64-d point features, 1024-d
globals, two layers of 256 per head, 32 GroupNorm groups per head and a
3 + 3 rot6d neck. Anything else raises; the plain module path serves it.

Numerics: matmul operands in the compute dtype with f32 accumulation; biases,
GroupNorm (eps 1e-5), exact-erf GELU, the point reduction and the neck in
f32. The JAX package runs this head in bf16 whatever the model's dtype
(`catre.py:263` passes no compute dtype); the port uses the model's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..models.layers import gelu_exact, group_norm
from . import _build

LAUNCHES = {"rot_head": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int

IN_GLOBAL, IN_POINT, FEAT, GROUPS = 1024, 64, 256, 32


@dataclass(frozen=True)
class RotHeadPack:
    """Joint [head x | head y] parameters; (out, in) weights."""

    w_g: torch.Tensor      # (512, 1024) f32, for gterm
    w_pt: torch.Tensor     # (512, 64) cdt
    b0: torch.Tensor       # (512,) f32
    gn0s: torch.Tensor     # (512,)
    gn0b: torch.Tensor     # (512,)
    w1: torch.Tensor       # (2, 256, 256) cdt, one (out, in) block per head
    b1: torch.Tensor       # (512,)
    gn1s: torch.Tensor     # (512,)
    gn1b: torch.Tensor     # (512,)
    pw: torch.Tensor       # (2, P) point weights per head
    neck: torch.Tensor     # (6, 256): rows 0..2 head x, 3..5 head y
    bias6: torch.Tensor    # (6,) = sum(pw) * neck bias + point bias, per head
    cdt: torch.dtype


def pack_rot_head(head, cdt: torch.dtype) -> RotHeadPack:
    """Merge a flagship-width `ConvOutPerRotHead` into a `RotHeadPack`."""
    hx, hy = head.rot_head_x, head.rot_head_y
    for h in (hx, hy):
        if (h.layer0_global_weight.shape != (FEAT, IN_GLOBAL)
                or h.layer0_point_weight.shape != (FEAT, IN_POINT)
                or len(h.layers) != 1 or h.neck.weight.shape != (3, FEAT)
                or any(gn.num_groups != GROUPS for gn in h.gns)):
            raise ValueError("the fused rot head takes the flagship widths only: 1024 + 64 -> "
                             "256 -> 256 (GN 32) -> 3 per head")

    def cat(fn):
        return torch.cat([fn(hx).float(), fn(hy).float()], dim=0)

    pw = torch.stack([hx.point_weight, hy.point_weight]).float()
    bias6 = torch.cat([pw[0].sum() * hx.neck.bias + hx.point_bias,
                       pw[1].sum() * hy.neck.bias + hy.point_bias]).float()
    return RotHeadPack(
        w_g=cat(lambda h: h.layer0_global_weight),
        w_pt=cat(lambda h: h.layer0_point_weight).to(cdt),
        b0=cat(lambda h: h.layer0_bias),
        gn0s=cat(lambda h: h.gns[0].weight), gn0b=cat(lambda h: h.gns[0].bias),
        w1=torch.stack([hx.layers[0].weight, hy.layers[0].weight]).to(cdt),
        b1=cat(lambda h: h.layers[0].bias),
        gn1s=cat(lambda h: h.gns[1].weight), gn1b=cat(lambda h: h.gns[1].bias),
        pw=pw, neck=cat(lambda h: h.neck.weight), bias6=bias6, cdt=cdt,
    )


def rot_head_twin(pf, gterm, p: RotHeadPack, n_pcl: int):
    """Plain version of K3: pf (B, P, 64) cdt, gterm (B, 2, 512) f32 -> (B, 6)
    f32. Operands rounded to cdt, products in f32, as the kernel does."""
    P = pf.shape[1]
    is_pcl = (torch.arange(P, device=pf.device) < n_pcl)[None, :, None]
    x = (pf.float() @ p.w_pt.float().T + torch.where(is_pcl, gterm[:, 0:1], gterm[:, 1:2])
         + p.b0)
    a = gelu_exact(group_norm(x, p.gn0s, p.gn0b, 2 * GROUPS)).to(p.cdt).float()
    w1 = p.w1.float()
    x = torch.cat([a[..., :FEAT] @ w1[0].T, a[..., FEAT:] @ w1[1].T], dim=-1) + p.b1
    y = gelu_exact(group_norm(x, p.gn1s, p.gn1b, 2 * GROUPS))
    vx = torch.einsum("bpc,p->bc", y[..., :FEAT], p.pw[0])
    vy = torch.einsum("bpc,p->bc", y[..., FEAT:], p.pw[1])
    return torch.cat([vx @ p.neck[:3].T, vy @ p.neck[3:].T], dim=1) + p.bias6


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rot_head")
    lib.catre_rot_head.argtypes = [_P] * 14 + [_I] * 4 + [_P]
    lib.catre_rot_head.restype = _I
    return lib


def rot_head(pf, gterm, p: RotHeadPack, n_pcl: int):
    """K3 on packed parameters: pf (B, P, 64) in p.cdt, gterm (B, 2, 512) f32
    -> (B, 6) f32."""
    if pf.device.type == "cpu":
        return rot_head_twin(pf, gterm, p, n_pcl)
    if pf.device.type != "cuda":
        raise ValueError(f"rot_head: no kernel for device {pf.device}")
    B, P, cin = pf.shape
    if p.cdt not in (torch.float32, torch.bfloat16) or pf.dtype != p.cdt:
        raise ValueError(f"rot_head: pf is {pf.dtype}, compute dtype {p.cdt}")
    if cin != IN_POINT or gterm.shape != (B, 2, 2 * FEAT) or gterm.dtype != torch.float32:
        raise ValueError(f"rot_head: pf {tuple(pf.shape)} / gterm {tuple(gterm.shape)} "
                         f"{gterm.dtype} are not the flagship widths")
    if p.pw.shape != (2, P) or not 0 <= n_pcl <= P:
        raise ValueError(f"rot_head: {P} points, point weights {tuple(p.pw.shape)}, "
                         f"n_pcl={n_pcl}")
    args = [pf, gterm, p.w_pt, p.b0, p.gn0s, p.gn0b, p.w1, p.b1, p.gn1s, p.gn1b,
            p.pw, p.neck, p.bias6]
    _build.cuda_inputs("rot_head", *args)
    out = torch.empty(B, 6, device=pf.device, dtype=torch.float32)
    rc = _lib().catre_rot_head(*[t.data_ptr() for t in args], out.data_ptr(), B, P, n_pcl,
                               int(p.cdt == torch.bfloat16), _build.stream_handle(pf.device))
    _build.check(rc, "rot_head")
    LAUNCHES["rot_head"] += 1
    return out


def fused_conv_per_rot_head(point_feats, g_pcl, g_kps, head, n_pcl: int, cdt: torch.dtype):
    """Fused `ConvOutPerRotHead` forward: point_feats (B, P+K, 64), g_pcl and
    g_kps (B, 1024) -> (B, 6) f32 rotation deltas [rx | ry]."""
    p = pack_rot_head(head, cdt)
    gterm = torch.stack([g_pcl.float(), g_kps.float()], dim=1) @ p.w_g.T   # (B, 2, 512)
    return rot_head(point_feats.to(cdt).contiguous(), gterm.contiguous(), p, n_pcl)
