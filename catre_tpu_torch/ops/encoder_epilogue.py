"""PointNet encoder tails fused with the per-cloud max: kernels K1 and K2.

Counterpart of `catre_tpu/ops/pallas_encoder_epilogue.py`:
  - `dense_relu_max` (K2) replaces `fused_dense_relu_max` (:89):
    max over P of relu(x @ W^T + b), the STN conv3 tails;
  - `dense_relu_dense_max` (K1) replaces `fused_dense_relu_dense_max` (:98):
    max over P of (relu(x @ W3^T + b3) @ W4^T + b4), the main conv3->conv4 tail.
The encoder body (`encode_body`, :107) is `models.pointnet.PointNetFeat`,
which takes a pair of tails: `ENCODER_TAIL_TWINS` (plain PyTorch) or
`ENCODER_TAIL_KERNELS` (these wrappers). Both kernels are for inference:
they return no gradient and refuse a differentiable call. Their
differentiable counterparts, K5 and K6 with a routed backward, are in
`ops/encoder_epilogue_train.py` (`ENCODER_TAIL_TRAIN`).

Each wrapper runs its plain twin for a CPU tensor and launches its CUDA
kernel (`csrc/encoder_epilogue.cu`; the f32 builds in
`csrc/encoder_epilogue.cuh`, K1's bf16 build in `csrc/encoder_tail_wgmma.cuh`,
K2's in `csrc/encoder_stn_tail_wgmma.cuh`) for a CUDA tensor; it never falls
back. x is (N, P, Cin) in the compute dtype
`cdt` (float32 or bfloat16); weights are (out, in) and are cast to `cdt`; the
result is (N, Cout) float32. Rounding follows flax `Dense(dtype=cdt)`:
product rounded to `cdt`, bias added in `cdt`.

The bf16 kernels take the max of the bare f32 accumulator and round once
per (cloud, channel); rounding, adding the bias and ReLU are monotone, so
that is the same function. `dense_relu_max_folded_twin` and
`dense_relu_dense_max_folded_twin` are the plain versions of that order,
which tell a rounding fault from an accumulation fault. K2's bf16 kernel runs
a persistent grid of blocks that each keep one group of output channels for
the whole launch (`stn_tail_grid`, `stn_tail_schedule`). The bf16 bodies of
K1 and K2 are also the bf16 training forwards K6 and K5, which take their
limits (`check_k1_bf16`, `check_k2_bf16`).

On the kernel path each call is the profiler span `catre.op.K1` or
`catre.op.K2`, and its weights' casts and repack `catre.op.pack`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..models.layers import dense
from ..utils.profiler import span
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


def fold_max_rounded(acc, b, cdt):
    """max over P of a bare f32 accumulator (N, P, C), then flax Dense's
    rounding once per (cloud, channel): round to `cdt`, + b in `cdt`. Equal
    to rounding every row and then taking the max."""
    return (acc.amax(dim=1).to(cdt) + b.to(cdt)).float()


def dense_relu_max_folded_twin(x, w, b, cdt):
    """Plain version of K2 in its bf16 kernel's order: the product as the bare
    f32 sum of the `cdt` operands, its max over P, then round, + b, round,
    ReLU."""
    return torch.relu(fold_max_rounded(F.linear(x.float(), w.to(cdt).float()), b, cdt))


def dense_relu_dense_max_folded_twin(x, w3, b3, w4, b4, cdt):
    """Plain version of K1 in its bf16 kernel's order: the second product as
    the bare f32 sum of the `cdt` operands, its max over P, then round, + b4,
    round."""
    h = dense(x, w3, b3, cdt, act=True)
    return fold_max_rounded(F.linear(h.float(), w4.to(cdt).float()), b4, cdt)


def pack_panels(w):
    """A (N, K) bf16 weight in the order K1's bf16 kernel streams it: for each
    128-row block of outputs, for each 64-column panel, 128 rows of 128 bytes
    under the 128-byte swizzle (the 16-byte chunk c of row r stored at chunk
    position c ^ (r % 8)), 16 KB a stage, contiguous. N % 128 == 0, K % 64 == 0."""
    n, k = w.shape
    if n % 128 or k % 64:
        raise ValueError(f"pack_panels: weight {tuple(w.shape)} is not 128-row x 64-column blocks")
    with span("catre.op.pack"):
        v = w.reshape(n // 128, 128, k // 64, 8, 8).permute(0, 2, 1, 3, 4)    # (nb, kp, r, c, e)
        r = torch.arange(128, device=w.device)[:, None]
        chunk = torch.arange(8, device=w.device)[None, :] ^ (r & 7)       # stored at position p
        return v[:, :, r, chunk].contiguous()


def stn_tail_grid(n, cout, n_sms, chunks):
    """Persistent blocks of K2's bf16 kernel for n clouds of cout channels:
    the channels fall into `groups` of `chunks` x 128 (the last may hold
    fewer), and the grid is the largest multiple of `groups` that is at most
    `n_sms` and at most n x groups. -> (grid, groups)."""
    groups = -(-(cout // 128) // chunks)
    grid = groups * min(n_sms // groups, n)
    if grid < 1:
        raise ValueError(f"dense_relu_max: no grid for {n} clouds of {groups} channel groups "
                         f"on {n_sms} SMs")
    return grid, groups


def stn_tail_schedule(n, cout, n_sms, chunks):
    """The work of each of K2's persistent blocks, as the kernel walks it:
    block b keeps group b % groups and takes the clouds b // groups,
    + grid // groups, ... -> (grid, [[(cloud, group), ...] per block])."""
    grid, groups = stn_tail_grid(n, cout, n_sms, chunks)
    return grid, [[(cloud, b % groups) for cloud in range(b // groups, n, grid // groups)]
                  for b in range(grid)]


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("encoder_epilogue")
    lib.catre_dense_relu_max.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.catre_dense_relu_max.restype = _I
    lib.catre_stn_tail_chunks.restype = _I
    lib.catre_stn_tail_smem.restype = _I
    lib.catre_dense_relu_dense_max.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.catre_dense_relu_dense_max.restype = _I
    return lib


_TRAIN_OP = ("ops.encoder_epilogue_train.ENCODER_TAIL_TRAIN (kernels K5/K6), or the plain "
             "encoder layers (ENCODER_TAIL_TWINS under autograd)")


def _kernel_operands(name, x, cdt, weights, biases):
    """Validate x and return (weights in cdt, biases rounded to cdt as f32)."""
    _build.refuse_grad(name, _TRAIN_OP, x, *weights, *biases)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {cdt} is not float32 or bfloat16")
    if x.dtype != cdt or x.dim() != 3:
        raise ValueError(f"{name}: x must be (N, P, C) {cdt}, got {tuple(x.shape)} {x.dtype}")
    with span("catre.op.pack"):
        ws = [w.to(device=x.device, dtype=cdt).contiguous() for w in weights]
        bs = [b.to(device=x.device, dtype=cdt).float().contiguous() for b in biases]
    _build.cuda_inputs(name, x, *ws, *bs)
    return ws, bs


def _check_widths(name, cin, *couts):
    if cin % 64 or any(c % 128 for c in couts):
        raise ValueError(f"{name}: widths {cin}->{couts} must be multiples of 64 -> 128")


# what the bf16 K1 holds in a block's shared memory: 64 x rows per warpgroup
# (cin), the hidden tile (128 x chid) and the running maxima (cout)
BF16_MAX_CIN, BF16_MAX_HID, BF16_MAX_OUT = 128, 512, 4096


def check_k1_bf16(name, x, cin, chid, cout):
    """Raise for what the bf16 K1 body (`csrc/encoder_tail_wgmma.cuh`, also
    the bf16 K6 forward) does not take: widths above 128 -> 512 -> 4096
    (multiples of 64 -> 128 are checked by `_check_widths`), or an x that
    does not start on a 16-byte boundary (its rows arrive by bulk copy). x
    None checks the widths alone."""
    if cin > BF16_MAX_CIN or chid > BF16_MAX_HID or cout > BF16_MAX_OUT:
        raise ValueError(f"{name}: bf16 widths {cin}->{chid}->{cout} exceed "
                         f"{BF16_MAX_CIN}->{BF16_MAX_HID}->{BF16_MAX_OUT}")
    if x is not None and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary (bulk copies)")


def check_k2_bf16(name, x, cin):
    """Raise for what the bf16 K2 body (`csrc/encoder_stn_tail_wgmma.cuh`,
    also the bf16 K5 forward) does not take: an input width other than 64 or
    128 (its A registers; cout a multiple of 128 is checked by
    `_check_widths`), or an x that does not start on a 16-byte boundary (its
    rows are copied 16 bytes at a time). x None checks the width alone."""
    if cin not in (64, 128):
        raise ValueError(f"{name}: the bf16 kernel takes 64 or 128 input channels "
                         f"(its A registers), got {cin}")
    if x is not None and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary (16-byte copies)")


def dense_relu_max(x, w, b, cdt):
    """K2: max over P of relu(x @ w^T + b); x (N, P, Cin) -> (N, Cout) f32.
    In bf16 Cin is 64 or 128 and x starts on a 16-byte boundary (its rows
    are copied 16 bytes at a time)."""
    if x.device.type == "cpu":
        return dense_relu_max_twin(x, w, b, cdt)
    with span("catre.op.K2"):
        return _dense_relu_max(x, w, b, cdt)


def _dense_relu_max(x, w, b, cdt):
    (w,), (b,) = _kernel_operands("dense_relu_max", x, cdt, [w], [b])
    N, P, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin) or b.shape != (cout,):
        raise ValueError(f"dense_relu_max: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    _check_widths("dense_relu_max", cin, cout)
    grid = 0
    if cdt == torch.bfloat16:
        check_k2_bf16("dense_relu_max", x, cin)
        grid, _ = stn_tail_grid(N, cout, _sm_count(x.device.index),
                                _lib().catre_stn_tail_chunks())
    out = torch.empty(N, cout, device=x.device, dtype=torch.float32)
    rc = _lib().catre_dense_relu_max(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, P, cin, cout,
        int(cdt == torch.bfloat16), grid, _build.stream_handle(x.device))
    _build.check(rc, "dense_relu_max")
    LAUNCHES["dense_relu_max"] += 1
    return out


def dense_relu_dense_max(x, w3, b3, w4, b4, cdt):
    """K1: max over P of (relu(x @ w3^T + b3) @ w4^T + b4); x (N, P, Cin) ->
    (N, C4) f32. The (N, P, C4) activation never reaches device memory. In
    bf16 the weights are repacked per call (`pack_panels`, 1.2 MB at the
    flagship widths) and x starts on a 16-byte boundary."""
    if x.device.type == "cpu":
        return dense_relu_dense_max_twin(x, w3, b3, w4, b4, cdt)
    with span("catre.op.K1"):
        return _dense_relu_dense_max(x, w3, b3, w4, b4, cdt)


def _dense_relu_dense_max(x, w3, b3, w4, b4, cdt):
    (w3, w4), (b3, b4) = _kernel_operands("dense_relu_dense_max", x, cdt, [w3, w4], [b3, b4])
    N, P, cin = x.shape
    chid, cout = w3.shape[0], w4.shape[0]
    if (w3.shape != (chid, cin) or w4.shape != (cout, chid)
            or b3.shape != (chid,) or b4.shape != (cout,)):
        raise ValueError(f"dense_relu_dense_max: weights {tuple(w3.shape)}, {tuple(w4.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    _check_widths("dense_relu_dense_max", cin, chid, cout)
    if cdt == torch.bfloat16:
        check_k1_bf16("dense_relu_dense_max", x, cin, chid, cout)
        w3, w4 = pack_panels(w3), pack_panels(w4)
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
