"""Differentiable fused rotation heads: K3 forward, kernel K4 backward.

Counterpart of `catre_tpu/ops/pallas_heads_vjp.py::fused_rot_head_train`
(:263), a `jax.custom_vjp` whose forward is the inference kernel (:268-272)
and whose backward `_bwd` (:281) launches `_bwd_kernel` (:100) through
`_run_bwd_joint` (:211). Here:
  - `RotHeadTrain`, a `torch.autograd.Function`: its forward launches K3
    (`ops.rot_head.rot_head`) and saves only its inputs, since the backward
    recomputes the forward (the JAX residuals are the inputs too, :275-278);
    its backward calls `rot_head_bwd`, which launches K4
    (`csrc/rot_head_bwd.cu`) for CUDA tensors and runs the plain version
    `rot_head_bwd_twin` for CPU tensors;
  - `rot_head_train(point_feats, g_pcl, g_kps, head, n_pcl, cdt)`, the model's
    training rot head. Outside the Function autograd takes the W_g / g
    gradients through gterm = g @ W_g^T, the folded bias
    bias6 = sum(pw) * neck_b + pb (d_bias6 = sum_b d_out) and the unpacking
    into the two `RotHead`s, as `_bwd` does at :322-347.
The kernel's two builds take different buffers (`SLOTS`): bf16 runs one block
per (object, head) on `wgmma` with the head's weights resident in shared
memory, recomputes the f32 pre-activations and keeps only the bf16 operands of
the weight-gradient products in device memory (a, d_x2, d_x0, each (B, P, 512),
columns in the kernel's fragment order) and the two heads' f32 d_pf partials;
f32 runs one block per object with the pre-activations x0, x2 in an f32
scratch (8 bytes per point and channel) and transposed weight copies.
The Function takes the packed weights in f32 and casts them to the compute
dtype inside, so the weight gradients stay f32 (`prep`, :284-289); d_pf comes
back in pf's dtype (:374).

On a CUDA tensor `rot_head_train` is the profiler span `catre.op.K3` and
`rot_head_bwd` `catre.op.K4` (on autograd's device thread), each with its
weights' packing and casts as `catre.op.pack`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..utils.profiler import span
from . import _build
from .rot_head import FEAT, IN_POINT, RotHeadPack, pack_rot_head, rot_head, rot_head_twin

LAUNCHES = {"rot_head_bwd": 0}

# gradients K4 returns, and the inputs of `RotHeadTrain` they belong to
GRAD_NAMES = ("pf", "gterm", "w_pt", "b0", "gn0s", "gn0b", "w1", "b1", "gn1s", "gn1b", "pw",
              "neck")
# pointer slots of catre_rot_head_bwd, the order of `Slot` in csrc/rot_head_bwd.cu
SLOTS = ("pf", "gterm", "dout", "w_pt", "w1", "w1t", "w_pt_t", "b0", "gn0s", "gn0b", "b1",
         "gn1s", "gn1b", "pw", "neck",
         "x0", "x2", "act", "d2", "d0", "pfpart", "pobj", "ppw", "pneck", "gpart",
         "d_pf", "d_gterm", "d_vec", "d_pw", "d_neck", "d_w_pt", "d_w1")
# slots only one build takes (the other passes a null pointer): the f32 build
# keeps the pre-activations x0, x2 in device memory and reads transposed weight
# copies; the bf16 build recomputes, reads the staged weights both ways, and
# joins the two heads' d_pf partials
F32_ONLY = ("w1t", "w_pt_t", "x0", "x2")
BF16_ONLY = ("pfpart",)
C = 2 * FEAT
# rows of d_vec, the six per-channel parameter gradients
VEC_ROWS = ("b0", "gn0s", "gn0b", "b1", "gn1s", "gn1b")
SPLIT_ROWS = 4096   # K rows per range of the weight-gradient products, at most 128 ranges


def rot_head_bwd_twin(pf, gterm, p: RotHeadPack, n_pcl: int, d_out) -> dict:
    """Plain version of K4: `torch.autograd.grad` of `rot_head_twin` with
    respect to pf, gterm and the f32 packed parameters of `p`, given d_out
    (B, 6). The matmul operands pf, w_pt and w1 are rounded to p.cdt on the
    way forward with their gradients passed straight through, so the
    gradients are f32, as the kernel's are. -> {name: gradient} (GRAD_NAMES)."""
    with torch.enable_grad():
        leaves = {n: t.detach().float().requires_grad_()
                  for n, t in zip(GRAD_NAMES, (pf, gterm, p.w_pt, p.b0, p.gn0s, p.gn0b, p.w1,
                                               p.b1, p.gn1s, p.gn1b, p.pw, p.neck))}

        def rounded(t):
            return t + (t.to(p.cdt).float() - t).detach()

        pack = dataclasses.replace(
            p, w_pt=rounded(leaves["w_pt"]), w1=rounded(leaves["w1"]),
            **{n: leaves[n] for n in ("b0", "gn0s", "gn0b", "b1", "gn1s", "gn1b", "pw", "neck")})
        out = rot_head_twin(rounded(leaves["pf"]), leaves["gterm"], pack, n_pcl)
        grads = torch.autograd.grad(out, list(leaves.values()), d_out.float())
    return dict(zip(GRAD_NAMES, grads))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rot_head_bwd")
    lib.catre_rot_head_bwd.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.catre_rot_head_bwd.restype = ctypes.c_int
    lib.catre_rot_head_bwd_slots.restype = ctypes.c_int
    lib.catre_wgmma_tn.argtypes = [ctypes.c_void_p] * 7
    lib.catre_wgmma_tn.restype = ctypes.c_int
    if lib.catre_rot_head_bwd_slots() != len(SLOTS):
        raise _build.KernelBuildError("rot_head_bwd: the library's pointer slots differ from SLOTS")
    return lib


def rot_head_bwd(pf, gterm, p: RotHeadPack, n_pcl: int, d_out) -> dict:
    """K4: gradients of `rot_head` (K3) given d_out (B, 6) f32. pf (B, P, 64)
    in p.cdt, gterm (B, 2, 512) f32, p with f32 weights. -> {name: gradient}
    (GRAD_NAMES), all f32, the parameter gradients summed over objects."""
    if pf.device.type == "cpu":
        return rot_head_bwd_twin(pf, gterm, p, n_pcl, d_out)
    if pf.device.type != "cuda":
        raise ValueError(f"rot_head_bwd: no kernel for device {pf.device}")
    with span("catre.op.K4"):
        return _rot_head_bwd(pf, gterm, p, n_pcl, d_out)


def _rot_head_bwd(pf, gterm, p: RotHeadPack, n_pcl: int, d_out) -> dict:
    B, P, cin = pf.shape
    cdt = p.cdt
    if cdt not in (torch.float32, torch.bfloat16) or pf.dtype != cdt:
        raise ValueError(f"rot_head_bwd: pf is {pf.dtype}, compute dtype {cdt}")
    weights = (p.w_pt, p.b0, p.gn0s, p.gn0b, p.w1, p.b1, p.gn1s, p.gn1b, p.pw, p.neck)
    if any(w.dtype != torch.float32 for w in (gterm, d_out, *weights)):
        raise ValueError("rot_head_bwd: gterm, d_out and the packed weights must be float32")
    shapes = {"pf": (pf.shape, (B, P, IN_POINT)), "gterm": (gterm.shape, (B, 2, C)),
              "d_out": (d_out.shape, (B, 6)), "w_pt": (p.w_pt.shape, (C, IN_POINT)),
              "w1": (p.w1.shape, (2, FEAT, FEAT)), "pw": (p.pw.shape, (2, P)),
              "neck": (p.neck.shape, (6, FEAT))}
    shapes.update({n: (getattr(p, n).shape, (C,)) for n in VEC_ROWS})
    bad = {n: tuple(s) for n, (s, want) in shapes.items() if tuple(s) != want}
    if bad or cin != IN_POINT or not 0 <= n_pcl <= P:
        raise ValueError(f"rot_head_bwd: not the flagship widths: {bad}, P={P}, n_pcl={n_pcl}")
    _build.cuda_inputs("rot_head_bwd", pf, gterm, d_out, *weights)

    dev = pf.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*shape, device=dev, dtype=dtype)

    bf16 = cdt == torch.bfloat16
    with span("catre.op.pack"):
        w_pt = p.w_pt.to(cdt).contiguous()
        w1 = p.w1.to(cdt).contiguous()
    splits = max(1, min(128, -(-(B * P) // SPLIT_ROWS)))
    bufs = dict(
        pf=pf, gterm=gterm, dout=d_out, w_pt=w_pt, w1=w1,
        b0=p.b0, gn0s=p.gn0s, gn0b=p.gn0b, b1=p.b1, gn1s=p.gn1s, gn1b=p.gn1b,
        pw=p.pw, neck=p.neck,
        act=empty(B, P, C, dtype=cdt), d2=empty(B, P, C, dtype=cdt), d0=empty(B, P, C, dtype=cdt),
        pobj=empty(B, 6, C), ppw=empty(B, 2, P), pneck=empty(B, 6, FEAT),
        gpart=empty(splits, 2 * FEAT * FEAT),
        d_pf=empty(B, P, IN_POINT), d_gterm=empty(B, 2, C), d_vec=empty(6, C),
        d_pw=empty(2, P), d_neck=empty(6, FEAT), d_w_pt=empty(C, IN_POINT),
        d_w1=empty(2, FEAT, FEAT))
    if bf16:
        bufs["pfpart"] = empty(2, B, P, IN_POINT)
    else:
        with span("catre.op.pack"):
            w_pt_t = torch.zeros(128, C, device=dev, dtype=cdt)   # W_pt^T, zero rows 64..127
            w_pt_t[:IN_POINT] = w_pt.T
            w1t = w1.transpose(1, 2).contiguous()
        bufs.update(w1t=w1t, w_pt_t=w_pt_t, x0=empty(B, P, C), x2=empty(B, P, C))
    absent = F32_ONLY if bf16 else BF16_ONLY
    ptrs = (ctypes.c_void_p * len(SLOTS))(*[None if n in absent else bufs[n].data_ptr()
                                            for n in SLOTS])
    rc = _lib().catre_rot_head_bwd(ptrs, B, P, n_pcl, int(bf16), splits,
                                   _build.stream_handle(dev))
    _build.check(rc, "rot_head_bwd")
    LAUNCHES["rot_head_bwd"] += 1
    grads = {"pf": bufs["d_pf"], "gterm": bufs["d_gterm"], "w_pt": bufs["d_w_pt"],
             "w1": bufs["d_w1"], "pw": bufs["d_pw"], "neck": bufs["d_neck"]}
    grads.update(zip(VEC_ROWS, bufs["d_vec"]))
    return grads


def wgmma_tn_plain(x, w0, w1):
    """x (64, 256), w0 (256, 64), w1 (256, 256) bf16 -> (x @ w1 (64, 256), x @ w0 (64, 64),
    x[:, :64] @ w0^T (64, 256)), f32 with f32 accumulation."""
    xf = x.float()
    return xf @ w1.float(), xf @ w0.float(), xf[:, :IN_POINT] @ w0.float().T


def wgmma_tn(x, w0, w1):
    """The tensor-core products of the bf16 K4 that K3 does not have, alone:
    a weight staged once as swizzled panels for the forward product and read
    transposed for the backward one (d_a = d_x2 W1, and d_pf = d_x0 W_pt
    accumulated over quarters of W_pt's rows), and the forward product by
    64-column quarters (`csrc/wgmma_tile.cuh::product_n64`). A check of that
    machinery on canned inputs; no launch of K4, so it is not counted."""
    if x.device.type == "cpu":
        return wgmma_tn_plain(x, w0, w1)
    for t, shape in ((x, (64, FEAT)), (w0, (FEAT, IN_POINT)), (w1, (FEAT, FEAT))):
        if t.shape != shape or t.dtype != torch.bfloat16:
            raise ValueError(f"wgmma_tn: {tuple(t.shape)} {t.dtype}, want {shape} bfloat16")
    _build.cuda_inputs("wgmma_tn", x, w0, w1)
    outs = [torch.empty(64, n, device=x.device, dtype=torch.float32)
            for n in (FEAT, IN_POINT, FEAT)]
    rc = _lib().catre_wgmma_tn(x.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                               *[o.data_ptr() for o in outs], _build.stream_handle(x.device))
    _build.check(rc, "wgmma_tn")
    return tuple(outs)


class RotHeadTrain(torch.autograd.Function):
    """out (B, 6) f32 = K3(pf, gterm, packed f32 weights cast to cdt); the
    backward is K4."""

    @staticmethod
    def forward(ctx, pf, gterm, w_pt, b0, gn0s, gn0b, w1, b1, gn1s, gn1b, pw, neck, bias6,
                n_pcl, cdt):
        ctx.save_for_backward(pf, gterm, w_pt, b0, gn0s, gn0b, w1, b1, gn1s, gn1b, pw, neck,
                              bias6)
        ctx.n_pcl, ctx.cdt = n_pcl, cdt
        with span("catre.op.pack", pf.is_cuda):
            p = _pack(w_pt.to(cdt), w1.to(cdt), b0, gn0s, gn0b, b1, gn1s, gn1b, pw, neck, bias6,
                      cdt)
        return rot_head(pf, gterm, p, n_pcl)

    @staticmethod
    def backward(ctx, d_out):
        pf, gterm, w_pt, b0, gn0s, gn0b, w1, b1, gn1s, gn1b, pw, neck, bias6 = ctx.saved_tensors
        p = _pack(w_pt, w1, b0, gn0s, gn0b, b1, gn1s, gn1b, pw, neck, bias6, ctx.cdt)
        g = rot_head_bwd(pf, gterm, p, ctx.n_pcl, d_out.float().contiguous())
        return (g["pf"].to(pf.dtype), *(g[n] for n in GRAD_NAMES[1:]), d_out.sum(dim=0),
                None, None)


def _pack(w_pt, w1, b0, gn0s, gn0b, b1, gn1s, gn1b, pw, neck, bias6, cdt) -> RotHeadPack:
    return RotHeadPack(w_g=None, w_pt=w_pt, b0=b0, gn0s=gn0s, gn0b=gn0b, w1=w1, b1=b1,
                       gn1s=gn1s, gn1b=gn1b, pw=pw, neck=neck, bias6=bias6, cdt=cdt)


def rot_head_train(point_feats, g_pcl, g_kps, head, n_pcl: int, cdt: torch.dtype):
    """Differentiable fused `ConvOutPerRotHead` forward: point_feats (B, P+K,
    64), g_pcl and g_kps (B, 1024) -> (B, 6) f32 rotation deltas [rx | ry];
    K3 forward, K4 backward."""
    on = point_feats.is_cuda
    with span("catre.op.K3", on):
        with span("catre.op.pack", on):
            p = pack_rot_head(head, cdt, weight_dtype=torch.float32)
            gterm = torch.stack([g_pcl.float(), g_kps.float()], dim=1) @ p.w_g.T   # (B, 2, 512)
        return RotHeadTrain.apply(point_feats.to(cdt).contiguous(), gterm.contiguous(), p.w_pt,
                                  p.b0, p.gn0s, p.gn0b, p.w1, p.b1, p.gn1s, p.gn1b, p.pw, p.neck,
                                  p.bias6, n_pcl, cdt)
