"""PointNet encoder tails fused with the per-cloud max: kernels K1 and K2.

Counterpart of `catre_tpu/ops/pallas_encoder_epilogue.py`:
  - `dense_relu_max` (K2) replaces `fused_dense_relu_max` (:89):
    max over P of relu(x @ W^T + b), the STN conv3 tails;
  - `dense_relu_dense_max` (K1) replaces `fused_dense_relu_dense_max` (:98):
    max over P of (relu(x @ W3^T + b3) @ W4^T + b4), the main conv3->conv4 tail.
The encoder body (`encode_body`, :107) is `models.pointnet.PointNetFeat`,
which takes a pair of tails: `ENCODER_TAIL_TWINS` (plain PyTorch) or
`ENCODER_TAIL_KERNELS` (these wrappers).

Each wrapper runs its plain twin for a CPU tensor and launches its CUDA
kernel (`csrc/encoder_epilogue.cu`) for a CUDA tensor; it never falls back.
x is (N, P, Cin) in the compute dtype `cdt` (float32 or bfloat16); weights
are (out, in) and are cast to `cdt`; the result is (N, Cout) float32.
Rounding follows flax `Dense(dtype=cdt)`: product rounded to `cdt`, bias
added in `cdt`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.layers import dense
from . import _build

LAUNCHES = {"dense_relu_max": 0, "dense_relu_dense_max": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def dense_relu_max_twin(x, w, b, cdt):
    """Plain version of K2: materialises the (N, P, Cout) activation."""
    return dense(x, w, b, cdt, act=True).amax(dim=1).float()


def dense_relu_dense_max_twin(x, w3, b3, w4, b4, cdt):
    """Plain version of K1: materialises both activations."""
    h = dense(x, w3, b3, cdt, act=True)
    return dense(h, w4, b4, cdt).amax(dim=1).float()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("encoder_epilogue")
    lib.catre_dense_relu_max.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.catre_dense_relu_max.restype = _I
    lib.catre_dense_relu_dense_max.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.catre_dense_relu_dense_max.restype = _I
    return lib


def _kernel_operands(name, x, cdt, weights, biases):
    """Validate x and return (weights in cdt, biases rounded to cdt as f32)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {cdt} is not float32 or bfloat16")
    if x.dtype != cdt or x.dim() != 3:
        raise ValueError(f"{name}: x must be (N, P, C) {cdt}, got {tuple(x.shape)} {x.dtype}")
    ws = [w.to(device=x.device, dtype=cdt).contiguous() for w in weights]
    bs = [b.to(device=x.device, dtype=cdt).float().contiguous() for b in biases]
    _build.cuda_inputs(name, x, *ws, *bs)
    return ws, bs


def _check_widths(name, cin, *couts):
    if cin % 64 or any(c % 128 for c in couts):
        raise ValueError(f"{name}: widths {cin}->{couts} must be multiples of 64 -> 128")


def dense_relu_max(x, w, b, cdt):
    """K2: max over P of relu(x @ w^T + b); x (N, P, Cin) -> (N, Cout) f32."""
    if x.device.type == "cpu":
        return dense_relu_max_twin(x, w, b, cdt)
    (w,), (b,) = _kernel_operands("dense_relu_max", x, cdt, [w], [b])
    N, P, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin) or b.shape != (cout,):
        raise ValueError(f"dense_relu_max: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    _check_widths("dense_relu_max", cin, cout)
    out = torch.empty(N, cout, device=x.device, dtype=torch.float32)
    rc = _lib().catre_dense_relu_max(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, P, cin, cout,
        int(cdt == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, "dense_relu_max")
    LAUNCHES["dense_relu_max"] += 1
    return out


def dense_relu_dense_max(x, w3, b3, w4, b4, cdt):
    """K1: max over P of (relu(x @ w3^T + b3) @ w4^T + b4); x (N, P, Cin) ->
    (N, C4) f32. The (N, P, C4) activation never reaches device memory."""
    if x.device.type == "cpu":
        return dense_relu_dense_max_twin(x, w3, b3, w4, b4, cdt)
    (w3, w4), (b3, b4) = _kernel_operands("dense_relu_dense_max", x, cdt, [w3, w4], [b3, b4])
    N, P, cin = x.shape
    chid, cout = w3.shape[0], w4.shape[0]
    if (w3.shape != (chid, cin) or w4.shape != (cout, chid)
            or b3.shape != (chid,) or b4.shape != (cout,)):
        raise ValueError(f"dense_relu_dense_max: weights {tuple(w3.shape)}, {tuple(w4.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    _check_widths("dense_relu_dense_max", cin, chid, cout)
    out = torch.empty(N, cout, device=x.device, dtype=torch.float32)
    rc = _lib().catre_dense_relu_dense_max(
        x.data_ptr(), w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(),
        out.data_ptr(), N, P, cin, chid, cout, int(cdt == torch.bfloat16),
        _build.stream_handle(x.device))
    _build.check(rc, "dense_relu_dense_max")
    LAUNCHES["dense_relu_dense_max"] += 1
    return out


ENCODER_TAIL_TWINS = (dense_relu_max_twin, dense_relu_dense_max_twin)
ENCODER_TAIL_KERNELS = (dense_relu_max, dense_relu_dense_max)
