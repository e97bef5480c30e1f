"""Both rotation heads with several objects per block: kernels K7 and K8.

Counterpart of two Pallas kernels of the JAX package:
  - K7 `catre_tpu/ops/pallas_heads.py::fused_conv_per_rot_head` (:276) with
    `group > 1` (body `_kernel_grouped` :183): `rot_head_grouped`;
  - K8 `catre_tpu/ops/pallas_heads_blocked.py::fused_conv_per_rot_head_blocked`
    (:112, body `_blocked_kernel` :25): `rot_head_blocked`.
On the TPU the two differ in how G objects share one grid step (stacked
GroupNorm statistics and block-diagonal point weights in K7, per-head static
slices in K8) and K8 takes one gterm per head; both compute one function. On
this card they are one CUDA kernel behind two wrappers with a launch counter
each, on the packed parameters of `ops/rot_head.py::pack_rot_head`: K3's
(`csrc/rot_head.cu`, entry `catre_rot_head_multi`), instantiated with G = 2,
4 or 8 objects per block and the rounded point reduction. A block owns (G
objects, one head) and stages the head's weights once; in bf16 the three G
give the same bits, and any P that K3 takes runs.

The function is K3's but for the point reduction: both Pallas bodies round
y = GELU(GN1(x1)) and the point weights pw to the compute dtype before
`sum_p pw[p] * y[p]` (`pallas_heads.py:243-248`,
`pallas_heads_blocked.py:64-67`), where K3 keeps both in f32
(`pallas_heads.py:171`). In f32 nothing shows; in bf16 it moves the result,
so the kernel and its plain version `rot_head_multi_twin` both round.

Each wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, never falling back; both raise unless the objects per
block divide B. As in JAX, any G that divides B runs on the CPU; on the card
a G outside `OBJECTS_PER_BLOCK` raises. The fallback of the grouped form to K3 is in
`ops/rot_head.py::fused_conv_per_rot_head`, the blocked form's in the model.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .rot_head import RotHeadPack, kernel_operands, rot_head_twin

LAUNCHES = {"rot_head_grouped": 0, "rot_head_blocked": 0}
OBJECTS_PER_BLOCK = (2, 4, 8)

_P = ctypes.c_void_p
_I = ctypes.c_int


def rot_head_multi_twin(pf, gterm, p: RotHeadPack, n_pcl: int):
    """Plain version of K7/K8: `rot_head_twin` with the point reduction's
    operands rounded to the compute dtype."""
    return rot_head_twin(pf, gterm, p, n_pcl, round_reduction=True)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rot_head")
    lib.catre_rot_head_multi.argtypes = [_P] * 14 + [_I] * 5 + [_P]
    lib.catre_rot_head_multi.restype = _I
    return lib


def _rot_head_multi(name: str, pf, gterm, p: RotHeadPack, n_pcl: int, group: int):
    B, P, _ = pf.shape
    if group < 1 or B % group:
        raise ValueError(f"{name}: {group} objects per block do not divide B = {B}")
    if pf.device.type == "cpu":                  # the plain version does not depend on G
        return rot_head_multi_twin(pf, gterm, p, n_pcl)
    if group not in OBJECTS_PER_BLOCK:
        raise ValueError(f"{name}: {group} objects per block; the kernel is built for "
                         f"{OBJECTS_PER_BLOCK} (ROADMAP queue 3, \"objects per block\")")
    kernel_operands(name, pf, gterm, p, n_pcl)
    args = [pf, gterm, p.w_pt, p.b0, p.gn0s, p.gn0b, p.w1, p.b1, p.gn1s, p.gn1b,
            p.pw, p.neck, p.bias6]
    _build.cuda_inputs(name, *args)
    out = torch.empty(B, 6, device=pf.device, dtype=torch.float32)
    rc = _lib().catre_rot_head_multi(*[t.data_ptr() for t in args], out.data_ptr(), B, P, n_pcl,
                                     group, int(p.cdt == torch.bfloat16),
                                     _build.stream_handle(pf.device))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def rot_head_grouped(pf, gterm, p: RotHeadPack, n_pcl: int, group: int):
    """K7 on packed parameters: pf (B, P, 64) in p.cdt, gterm (B, 2, 512) f32
    -> (B, 6) f32, `group` objects per block."""
    return _rot_head_multi("rot_head_grouped", pf, gterm, p, n_pcl, group)


def rot_head_blocked(pf, gterm, p: RotHeadPack, n_pcl: int, block_size: int):
    """K8 on packed parameters: as `rot_head_grouped`, `block_size` objects per
    block."""
    return _rot_head_multi("rot_head_blocked", pf, gterm, p, n_pcl, block_size)
