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

The bf16 build (`csrc/encoder_chain_wgmma.cuh`) has two designs on the
`wgmma` kernels of K1 and K2, and takes the widths of the model's columns
(`check_k9_bf16`): the main design 64 -> 128 -> c2 -> c3 (K1's kernel, one
block per cloud, the weights repacked per call as 16 KB stages by
`pack_panels`) and the STN design 3 or 64 -> 64 -> 128 -> c3 (K2's
persistent grid, `stn_tail_grid`, the weights staged by the kernel from
their own layout). The f32 build (`gemm_tile`) takes any widths in multiples
of 64 -> 128 -> 128 after the first, for checks.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .encoder_epilogue import _sm_count, pack_panels, stn_tail_grid

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
    lib.catre_chain3_max.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.catre_chain3_max.restype = _I
    lib.catre_chain3_max_smem.argtypes = [_I] * 5
    lib.catre_chain3_max_smem.restype = _I
    lib.catre_chain3_max_chunks.restype = _I
    return lib


# the widths the bf16 designs take (csrc/encoder_chain_wgmma.cuh::design)
MAIN_CIN, MAIN_C1, MAIN_MAX_C2, MAIN_MAX_C3 = 64, 128, 512, 4096
STN_CINS, STN_C1, STN_C2 = (3, 64), 64, 128


def check_k9_widths(name, cin, c1, c2, c3):
    """Raise for widths that no build of K9 takes: after the first, multiples
    of 64, 128 and 128."""
    if c1 % 64 or c2 % 128 or c3 % 128:
        raise ValueError(f"{name}: widths {cin}->{c1}->{c2}->{c3} must be multiples of "
                         "64, 128, 128 after the first")


def check_k9_bf16(name, x, cin, c1, c2, c3):
    """Which bf16 design takes these widths, "main" or "stn"; raise, naming
    the limits, for widths neither takes (c3 a multiple of 128 is checked
    before) or for an x of 64 channels that does not start on a 16-byte
    boundary (its rows arrive by bulk copy or 16-byte `cp.async`). x None
    checks the widths alone."""
    if cin == MAIN_CIN and c1 == MAIN_C1 and c2 % 128 == 0 and c2 <= MAIN_MAX_C2 \
            and c3 <= MAIN_MAX_C3:
        design = "main"
    elif cin in STN_CINS and c1 == STN_C1 and c2 == STN_C2:
        design = "stn"
    else:
        raise ValueError(
            f"{name}: bf16 widths {cin}->{c1}->{c2}->{c3} are neither the main column's "
            f"{MAIN_CIN}->{MAIN_C1}->(a multiple of 128 up to {MAIN_MAX_C2})->(up to "
            f"{MAIN_MAX_C3}) nor an STN column's {' or '.join(map(str, STN_CINS))}->"
            f"{STN_C1}->{STN_C2}->c3")
    if cin % 8 == 0 and x is not None and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary (its rows are copied 16 "
                         "bytes at a time)")
    return design


def bf16_weights(design, w1, w2, w3):
    """The bf16 weights as the kernel of `design` takes them: "main" streams
    each as 128-row x 64-column swizzled stages (`pack_panels`), "stn" stages
    them itself from their (out, in) layout, stn3d's W1 (64, 3) included."""
    if design == "main":
        return [pack_panels(w) for w in (w1, w2, w3)]
    return [w.contiguous() for w in (w1, w2, w3)]


def bf16_grid(design, n, c3, n_sms, chunks):
    """Blocks of the bf16 launch: one per cloud for "main"; for "stn" K2's
    persistent grid (`stn_tail_grid`: channel groups of `chunks` x 128, the
    largest multiple of the groups within the SMs and n x groups)."""
    return n if design == "main" else stn_tail_grid(n, c3, n_sms, chunks)[0]


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
    check_k9_widths(name, cin, c1, c2, c3)
    x = x.to(cdt).contiguous()
    ws = [w.to(device=x.device, dtype=cdt).contiguous() for w in (w1, w2, w3)]
    bs = [b.to(device=x.device, dtype=torch.float32).contiguous() for b in (b1, b2, b3)]
    if cdt == torch.bfloat16:
        design = check_k9_bf16(name, x, cin, c1, c2, c3)
        ws = bf16_weights(design, *ws)
        grid = bf16_grid(design, N, c3, _sm_count(x.device.index), _lib().catre_chain3_max_chunks())
    else:
        if _lib().catre_chain3_max_smem(cin, c1, c2, c3, 0) > _build.SMEM_LIMIT:
            raise ValueError(f"{name}: the f32 tiles of widths {cin}->{c1}->{c2}->{c3} do not "
                             "fit a block's shared memory")
        # W1 zero-padded to the 128 x 64 granule of `gemm_tile` (x is padded in shared
        # memory, never in device memory)
        w1p = torch.zeros(-(-c1 // 128) * 128, -(-cin // 64) * 64, device=x.device, dtype=cdt)
        w1p[:c1, :cin] = ws[0]
        ws[0], grid = w1p, 0
    args = [x, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2]]
    _build.cuda_inputs(name, *args)
    out = torch.empty(N, c3, device=x.device, dtype=torch.float32)
    rc = _lib().catre_chain3_max(*[t.data_ptr() for t in args], out.data_ptr(), N, P, cin,
                                 c1, c2, c3, int(relu_last), int(cdt == torch.bfloat16), grid,
                                 _build.stream_handle(x.device))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out
