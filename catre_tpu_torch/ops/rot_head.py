"""Both rotation heads in one pass per object: kernel K3.

Counterpart of `catre_tpu/ops/pallas_heads.py::fused_conv_per_rot_head`
(:276). `fused_conv_per_rot_head` packs the two per-axis `RotHead`s of a
`ConvOutPerRotHead` into joint 512-channel blocks (`pack_rot_head`, as
`pallas_heads.py:294-322` does), computes the per-object global terms
`gterm = [g_pcl; g_kps] @ W_g^T` (B, 2, 512) outside the kernel (:326-329),
and on its `group=1` path calls `rot_head`, which runs the plain twin for a
CPU tensor and launches `csrc/rot_head.cu` for a CUDA tensor, never falling
back. With `group > 1` (K7), and in the blocked form
`fused_conv_per_rot_head_blocked` (K8, counterpart of
`pallas_heads_blocked.py:112`), several objects share a block: those run
`ops/rot_head_multi.py` over the same CUDA kernel, instantiated with G
objects per block and a rounded point reduction.

The kernel hard-codes the flagship widths: 64-d point features, 1024-d
globals, two layers of 256 per head, 32 GroupNorm groups per head and a
3 + 3 rot6d neck. Anything else raises; the plain module path serves it.

On a CUDA tensor a call of `fused_conv_per_rot_head` or
`fused_conv_per_rot_head_blocked` is the profiler span `catre.op.K3`,
`catre.op.K7` or `catre.op.K8`, and its packing and gterm product
`catre.op.pack`.

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
from ..utils.profiler import span
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


def check_rot_head_widths(in_global: int, in_point: int, feat: int, num_layers: int,
                          rot_dim: int, num_gn_groups: int) -> None:
    """Raise for a rotation head that the kernels (K3, K4, K7/K8) do not
    take: anything but 1024 + 64 -> 256 -> 256 (GN 32) -> 3 per head."""
    got = (in_global, in_point, feat, num_layers, rot_dim, num_gn_groups)
    if got != (IN_GLOBAL, IN_POINT, FEAT, 2, 3, GROUPS):
        raise ValueError("the fused rot head takes the flagship widths only: 1024 + 64 -> "
                         "256 -> 256 (GN 32) -> 3 per head; got inputs "
                         f"{in_global} + {in_point}, width {feat}, {num_layers} layers, "
                         f"{rot_dim} outputs, GN {num_gn_groups}")


def pack_rot_head(head, cdt: torch.dtype, weight_dtype: torch.dtype | None = None) -> RotHeadPack:
    """Merge a flagship-width `ConvOutPerRotHead` into a `RotHeadPack`. The
    matmul weights w_pt and w1 take `weight_dtype` (default `cdt`); the
    training op keeps them f32 so that autograd does not round their
    gradients through a cast. Differentiable in the head's parameters."""
    hx, hy = head.rot_head_x, head.rot_head_y
    for h in (hx, hy):
        groups = {gn.num_groups for gn in h.gns}
        check_rot_head_widths(h.layer0_global_weight.shape[1], h.layer0_point_weight.shape[1],
                              h.layer0_global_weight.shape[0], len(h.layers) + 1,
                              h.neck.weight.shape[0], groups.pop() if len(groups) == 1 else 0)
    wdt = cdt if weight_dtype is None else weight_dtype

    def cat(fn):
        return torch.cat([fn(hx).float(), fn(hy).float()], dim=0)

    pw = torch.stack([hx.point_weight, hy.point_weight]).float()
    bias6 = torch.cat([pw[0].sum() * hx.neck.bias + hx.point_bias,
                       pw[1].sum() * hy.neck.bias + hy.point_bias]).float()
    return RotHeadPack(
        w_g=cat(lambda h: h.layer0_global_weight),
        w_pt=cat(lambda h: h.layer0_point_weight).to(wdt),
        b0=cat(lambda h: h.layer0_bias),
        gn0s=cat(lambda h: h.gns[0].weight), gn0b=cat(lambda h: h.gns[0].bias),
        w1=torch.stack([hx.layers[0].weight, hy.layers[0].weight]).to(wdt),
        b1=cat(lambda h: h.layers[0].bias),
        gn1s=cat(lambda h: h.gns[1].weight), gn1b=cat(lambda h: h.gns[1].bias),
        pw=pw, neck=cat(lambda h: h.neck.weight), bias6=bias6, cdt=cdt,
    )


def rot_head_twin(pf, gterm, p: RotHeadPack, n_pcl: int, round_reduction: bool = False):
    """Plain version of K3: pf (B, P, 64) cdt, gterm (B, 2, 512) f32 -> (B, 6)
    f32. Operands rounded to cdt, products in f32, as the kernel does. With
    `round_reduction` the point reduction's operands y and pw are rounded to
    cdt too: the plain version of K7/K8 (`rot_head_multi.rot_head_multi_twin`)."""
    P = pf.shape[1]
    is_pcl = (torch.arange(P, device=pf.device) < n_pcl)[None, :, None]
    x = (pf.float() @ p.w_pt.float().T + torch.where(is_pcl, gterm[:, 0:1], gterm[:, 1:2])
         + p.b0)
    a = gelu_exact(group_norm(x, p.gn0s, p.gn0b, 2 * GROUPS)).to(p.cdt).float()
    w1 = p.w1.float()
    x = torch.cat([a[..., :FEAT] @ w1[0].T, a[..., FEAT:] @ w1[1].T], dim=-1) + p.b1
    y, pw = gelu_exact(group_norm(x, p.gn1s, p.gn1b, 2 * GROUPS)), p.pw
    if round_reduction:
        y, pw = y.to(p.cdt).float(), pw.to(p.cdt).float()
    vx = torch.einsum("bpc,p->bc", y[..., :FEAT], pw[0])
    vy = torch.einsum("bpc,p->bc", y[..., FEAT:], pw[1])
    return torch.cat([vx @ p.neck[:3].T, vy @ p.neck[3:].T], dim=1) + p.bias6


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rot_head")
    lib.catre_rot_head.argtypes = [_P] * 14 + [_I] * 4 + [_P]
    lib.catre_rot_head.restype = _I
    lib.catre_wgmma_chain.argtypes = [_P] * 6
    lib.catre_wgmma_chain.restype = _I
    return lib


_TRAIN_OP = "ops.rot_head_train.rot_head_train (K3 forward, K4 backward)"


def kernel_operands(name, pf, gterm, p: RotHeadPack, n_pcl: int) -> None:
    """What every rot-head forward kernel asks of its CUDA call: no gradient
    wanted, a CUDA device, the flagship widths, pf and the matmul weights in
    p.cdt. Raises otherwise."""
    _build.refuse_grad(name, _TRAIN_OP, pf, gterm, p.w_pt, p.b0, p.gn0s, p.gn0b, p.w1, p.b1,
                       p.gn1s, p.gn1b, p.pw, p.neck, p.bias6)
    if pf.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pf.device}")
    B, P, cin = pf.shape
    if (p.cdt not in (torch.float32, torch.bfloat16) or pf.dtype != p.cdt
            or p.w_pt.dtype != p.cdt or p.w1.dtype != p.cdt):
        raise ValueError(f"{name}: pf {pf.dtype}, weights {p.w_pt.dtype}/{p.w1.dtype}, "
                         f"compute dtype {p.cdt}")
    if cin != IN_POINT or gterm.shape != (B, 2, 2 * FEAT) or gterm.dtype != torch.float32:
        raise ValueError(f"{name}: pf {tuple(pf.shape)} / gterm {tuple(gterm.shape)} "
                         f"{gterm.dtype} are not the flagship widths")
    if p.pw.shape != (2, P) or not 0 <= n_pcl <= P:
        raise ValueError(f"{name}: {P} points, point weights {tuple(p.pw.shape)}, "
                         f"n_pcl={n_pcl}")


def rot_head(pf, gterm, p: RotHeadPack, n_pcl: int):
    """K3 on packed parameters: pf (B, P, 64) in p.cdt, gterm (B, 2, 512) f32
    -> (B, 6) f32."""
    if pf.device.type == "cpu":
        return rot_head_twin(pf, gterm, p, n_pcl)
    kernel_operands("rot_head", pf, gterm, p, n_pcl)
    args = [pf, gterm, p.w_pt, p.b0, p.gn0s, p.gn0b, p.w1, p.b1, p.gn1s, p.gn1b,
            p.pw, p.neck, p.bias6]
    _build.cuda_inputs("rot_head", *args)
    B, P, _ = pf.shape
    out = torch.empty(B, 6, device=pf.device, dtype=torch.float32)
    rc = _lib().catre_rot_head(*[t.data_ptr() for t in args], out.data_ptr(), B, P, n_pcl,
                               int(p.cdt == torch.bfloat16), _build.stream_handle(pf.device))
    _build.check(rc, "rot_head")
    LAUNCHES["rot_head"] += 1
    return out


def wgmma_chain_plain(x, w0, w1):
    """x (64, 64), w0 (256, 64), w1 (256, 256) bf16 -> (x @ w0^T, round_bf16(x @ w0^T) @ w1^T),
    both (64, 256) f32 with f32 accumulation."""
    out0 = x.float() @ w0.float().T
    return out0, out0.to(torch.bfloat16).float() @ w1.float().T


def wgmma_chain(x, w0, w1):
    """The two chained tensor-core products the bf16 K3 is built on, with
    nothing between them but the rounding: staged weight panels, A registers
    from a shared-memory tile, and the first product's accumulators packed
    as the second's A registers (`csrc/wgmma_tile.cuh`). A check of that
    machinery on canned inputs; no launch of K3, so it is not counted."""
    if x.device.type == "cpu":
        return wgmma_chain_plain(x, w0, w1)
    for t, shape in ((x, (64, IN_POINT)), (w0, (FEAT, IN_POINT)), (w1, (FEAT, FEAT))):
        if t.shape != shape or t.dtype != torch.bfloat16:
            raise ValueError(f"wgmma_chain: {tuple(t.shape)} {t.dtype}, want {shape} bfloat16")
    _build.cuda_inputs("wgmma_chain", x, w0, w1)
    out0, out1 = (torch.empty(64, FEAT, device=x.device, dtype=torch.float32) for _ in range(2))
    rc = _lib().catre_wgmma_chain(x.data_ptr(), w0.data_ptr(), w1.data_ptr(), out0.data_ptr(),
                                  out1.data_ptr(), _build.stream_handle(x.device))
    _build.check(rc, "wgmma_chain")
    return out0, out1


def _packed_inputs(point_feats, g_pcl, g_kps, head, cdt):
    """-> (pf in cdt, gterm (B, 2, 512) f32, pack) for the packed-parameter ops."""
    with span("catre.op.pack", point_feats.is_cuda):
        p = pack_rot_head(head, cdt)
        gterm = torch.stack([g_pcl.float(), g_kps.float()], dim=1) @ p.w_g.T
    return point_feats.to(cdt).contiguous(), gterm.contiguous(), p


def fused_conv_per_rot_head(point_feats, g_pcl, g_kps, head, n_pcl: int, cdt: torch.dtype,
                            group: int = 1):
    """Fused `ConvOutPerRotHead` forward: point_feats (B, P+K, 64), g_pcl and
    g_kps (B, 1024) -> (B, 6) f32 rotation deltas [rx | ry]. `group` > 1 runs
    that many objects per block (K7) when it divides B, and K3 when it does
    not (`pallas_heads.py:334`)."""
    grouped = group > 1 and point_feats.shape[0] % group == 0
    with span("catre.op.K7" if grouped else "catre.op.K3", point_feats.is_cuda):
        pf, gterm, p = _packed_inputs(point_feats, g_pcl, g_kps, head, cdt)
        if grouped:
            from .rot_head_multi import rot_head_grouped    # it imports this module
            return rot_head_grouped(pf, gterm, p, n_pcl, group)
        return rot_head(pf, gterm, p, n_pcl)


def fused_conv_per_rot_head_blocked(point_feats, g_pcl, g_kps, head, n_pcl: int,
                                    cdt: torch.dtype, block_size: int = 8):
    """The blocked form (K8): `block_size` objects per block; raises unless it
    divides B (`pallas_heads_blocked.py:120` asserts)."""
    from .rot_head_multi import rot_head_blocked
    with span("catre.op.K8", point_feats.is_cuda):
        pf, gterm, p = _packed_inputs(point_feats, g_pcl, g_kps, head, cdt)
        return rot_head_blocked(pf, gterm, p, n_pcl, block_size)
