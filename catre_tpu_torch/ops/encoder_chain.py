"""A PointNet column of three dense layers fused with the per-cloud max: kernel K9.

Counterpart of `catre_tpu/ops/pallas_encoder.py::chain3_max` (:55, body
`_chain_kernel` :25): max over points of x -> relu(W1) -> relu(W2) -> W3
(+ ReLU with `relu_last`), (N, P, Cin) -> (N, C3) f32. It serves the STN
columns conv1 -> conv2 -> conv3 (`relu_last=True`) and the main column
conv2 -> conv3 -> conv4 of `models.pointnet.PointNetFeat.forward_fused`
(`stn_forward_fused` :98, `pointnet_forward_fused` :118).

`chain3_max` runs its plain version for a CPU tensor and launches
`csrc/encoder_chain.cu` for a CUDA tensor; it never falls back. It is for
inference: it returns no gradient and refuses a differentiable call.
Weights are (out, in) and are cast to the compute dtype `cdt` (float32 or
bfloat16), as is x; biases stay f32. Unlike the JAX function, which runs
bf16 on a TPU whatever the model's dtype (:57), the caller names `cdt`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = {"chain3_max": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def chain3_max_twin(x, w1, b1, w2, b2, w3, b3, cdt, relu_last: bool = False):
    """Plain version of K9; materialises the three activations. The rounding
    points are `_chain_kernel`'s (`pallas_encoder.py:35-42`), not flax
    `Dense(dtype=cdt)`'s that `models.layers.dense` and K1/K2 follow: x and
    the weights in `cdt`, each product accumulated in f32, the f32 bias added
    in f32, one rounding to `cdt` after each of the first two ReLUs (:36-39),
    the last layer `dot + b3` left in f32 (:40), then the optional ReLU and
    the max in f32. Hence the f32 products of `cdt`-rounded operands below: a
    `cdt` matmul would round the sum before the bias is added."""
    def product(h, w):
        return F.linear(h.to(cdt).float(), w.to(cdt).float())

    h = torch.relu(product(x, w1) + b1.float()).to(cdt)
    h = torch.relu(product(h, w2) + b2.float()).to(cdt)
    h = product(h, w3) + b3.float()
    if relu_last:
        h = torch.relu(h)
    return h.amax(dim=1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("encoder_chain")
    lib.catre_chain3_max.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    lib.catre_chain3_max.restype = _I
    lib.catre_chain3_max_smem.argtypes = [_I] * 5
    lib.catre_chain3_max_smem.restype = _I
    return lib


def chain3_max(x, w1, b1, w2, b2, w3, b3, cdt, relu_last: bool = False):
    """K9: max over P of the three-layer chain; x (N, P, Cin) -> (N, C3) f32.
    No (points x channels) activation reaches device memory."""
    if x.device.type == "cpu":
        return chain3_max_twin(x, w1, b1, w2, b2, w3, b3, cdt, relu_last)
    name = "chain3_max"
    _build.refuse_grad(name, "the plain encoder layers under autograd, or "
                       "ops.encoder_epilogue_train.ENCODER_TAIL_TRAIN (kernels K5/K6)",
                       x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {cdt} is not float32 or bfloat16")
    if x.dim() != 3 or not x.is_floating_point():
        raise ValueError(f"{name}: x must be (N, P, C) floating point, got {tuple(x.shape)} "
                         f"{x.dtype}")
    N, P, cin = x.shape
    c1, c2, c3 = w1.shape[0], w2.shape[0], w3.shape[0]
    if (w1.shape != (c1, cin) or w2.shape != (c2, c1) or w3.shape != (c3, c2)
            or b1.shape != (c1,) or b2.shape != (c2,) or b3.shape != (c3,)):
        raise ValueError(f"{name}: weights {tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(w3.shape)} do not chain from x {tuple(x.shape)}")
    if c1 % 64 or c2 % 128 or c3 % 128:
        raise ValueError(f"{name}: widths {cin}->{c1}->{c2}->{c3} must be multiples of "
                         "64, 128, 128 after the first")
    bf16 = int(cdt == torch.bfloat16)
    if _lib().catre_chain3_max_smem(cin, c1, c2, c3, bf16) > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: the tiles of widths {cin}->{c1}->{c2}->{c3} do not fit a "
                         "block's shared memory")
    x = x.to(cdt).contiguous()
    # W1 zero-padded to the 128 x 64 granule of the kernel's products (x is
    # padded in shared memory, never in device memory)
    w1p = torch.zeros(-(-c1 // 128) * 128, -(-cin // 64) * 64, device=x.device, dtype=cdt)
    w1p[:c1, :cin] = w1
    ws = [w.to(device=x.device, dtype=cdt).contiguous() for w in (w2, w3)]
    bs = [b.to(device=x.device, dtype=torch.float32).contiguous() for b in (b1, b2, b3)]
    args = [x, w1p, bs[0], ws[0], bs[1], ws[1], bs[2]]
    _build.cuda_inputs(name, *args)
    out = torch.empty(N, c3, device=x.device, dtype=torch.float32)
    rc = _lib().catre_chain3_max(*[t.data_ptr() for t in args], out.data_ptr(), N, P, cin,
                                 c1, c2, c3, int(relu_last), bf16,
                                 _build.stream_handle(x.device))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out
