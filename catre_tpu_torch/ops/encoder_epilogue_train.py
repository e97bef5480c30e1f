"""Differentiable PointNet encoder tails: kernels K5 and K6.

Counterpart of `catre_tpu/ops/pallas_encoder_epilogue_vjp.py`:
  - `DenseReluMaxTrain` (K5) replaces `dense_relu_max_t` (:263): max over P
    of relu(x @ W^T + b), the STN conv3 tails;
  - `DenseReluDenseMaxTrain` (K6) replaces `dense_relu_dense_max_t` (:294):
    max over P of (relu(x @ W3^T + b3) @ W4^T + b4), the main tail;
  - `ENCODER_TAIL_TRAIN`, the pair `models.pointnet.PointNetFeat` takes for a
    differentiable call, as `pointnet_encode_fused_train` (:326) hands its
    pair to `encode_body`.
Each is a `torch.autograd.Function` whose forward launches the forward
kernel, which also returns idx (N, C) int32, the lowest point row that
attains the max of each (cloud, channel), and saves only (x, weights,
biases, idx) (the JAX residuals, :279, :311). The backward launches the
backward kernel, which sends each d_out[n, c] to row idx[n, c] alone. That
is the JAX kernels' tie rule (:17-19); `amax` under autograd splits a
gradient evenly across tied rows instead. No (N, P, C) activation, ReLU
mask or max mask reaches device memory.

The Functions take the f32 parameters and cast them inside, so weight and
bias gradients are f32 (:275-276, :287, :320); dx comes back in x's dtype,
as the backward wrappers return it: the bf16 kernels write it in bf16, each
element rounded once from its f32 sum, and on the CPU the plain version's
f32 dx is cast once (the Pallas wrappers cast the kernels' f32 dx, :287,
:320).
Rounding points differ between forward and backward, as in the Pallas
bodies: the forward rounds each product to `cdt` and adds the bias in `cdt`
(flax `Dense(dtype=cdt)`); the backward's recompute takes the f32 product,
the unrounded f32 bias and rounds once, after the ReLU (:81-86, :125-127).

Beside each kernel its plain PyTorch version, which the wrappers run for a
CPU tensor; for a CUDA tensor they launch `csrc/encoder_epilogue_train.cu`
or raise, never fall back. The plain backwards are routed like the kernels
(gather the argmax rows, scatter-add the row gradients) where the Pallas
bodies multiply by a dense one-hot matrix: the function is the same. Each
backward has a second plain version in its bf16 kernel's own order, on the
critical rows only, with `route_rows` mirroring the kernels' routing buffer:
`dense_relu_dense_max_bwd_critical_plain` (route, g, gate, the three
products) and `dense_relu_max_bwd_critical_plain` (gate, route the gated d,
the sums over each row's segment, dx in x's dtype, dW and db). Where a
kernel disagrees with both, routing is at fault, where with one, rounding.
The critical-row versions serve tests and checks only.

The bf16 K6 forward is K1's `wgmma` body (`csrc/encoder_tail_wgmma.cuh`
with kIdx), so its `out` is K1's by construction. It takes K1's weight
repack and widths (`encoder_epilogue.check_k1_bf16`) and at most
`ARGMAX_MAX_ROWS` points: the rounded value of every element becomes an
unsigned 32-bit key, value above the row (`argmax_key`), and the largest key
per (cloud, channel) is the max and its lowest tied row, whatever order the
kernel folds them in. `max_argmax_keyed` is the plain version of that fold,
for the tests and the card checks; on the CPU the wrapper runs
`dense_relu_dense_max_fwd_plain`. The bf16 K5 forward is likewise K2's
persistent `wgmma` body (`csrc/encoder_stn_tail_wgmma.cuh` with kIdx) on K2's
limits (`encoder_epilogue.check_k2_bf16`, its grid `stn_tail_grid`) and at
most `ARGMAX_MAX_ROWS` points; its keys are built after the ReLU, where the
bf16 bits of a value at or above +0 order it without an order image, and
`dense_relu_max_fwd_keyed_plain` is the plain version of its fold.

The bf16 K6 backward (`csrc/encoder_tail_bwd_wgmma.cuh`) takes cin 64 or
128, chid and cout multiples of 128 that fit its shared memory, and x on a
16-byte boundary, and allocates nothing of N x P x chid: a routing buffer of
N rows of about 4 cout int32 and per-group partials of the weight gradients
(`k6_bwd_schedule`). The bf16 K5 backward (`csrc/encoder_stn_tail_bwd.cuh`)
takes K2's limits (cin 64 or 128, x on a 16-byte boundary) and a cout whose
64-column chunk of W fits a block's shared memory, and allocates beside its
outputs d (N, cout) and one buffer that holds the per-group partials of dW
and db, then K6's routing rows of the gated d.

On the kernel path each call is the profiler span `catre.op.K5.fwd`,
`catre.op.K5.bwd`, `catre.op.K6.fwd` or `catre.op.K6.bwd` (the backwards on
autograd's device thread), and its weights' casts and repack
`catre.op.pack`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.layers import dense
from ..utils.profiler import span
from . import _build
from .encoder_epilogue import (_check_widths, _sm_count, check_k1_bf16, check_k2_bf16,
                               pack_panels, stn_tail_grid)

LAUNCHES = {"dense_relu_max_train_fwd": 0, "dense_relu_max_train_bwd": 0,
            "dense_relu_dense_max_train_fwd": 0, "dense_relu_dense_max_train_bwd": 0}

# pointer slots of catre_dense_relu_dense_max_train_bwd, the order of `Slot`
# in csrc/encoder_epilogue_train.cu; each build leaves the other's own slots null
K6_BWD_SLOTS = ("x", "w3", "b3", "w3t", "w4", "idx", "dout", "dh3", "pdb3", "part_w4", "part_b4",
                "gpart", "dx", "dw3", "db3", "dw4", "db4", "route", "part_w3", "part_b3")
K6_BWD_F32_ONLY = ("w3t", "dh3", "pdb3", "gpart")
K6_BWD_BF16_ONLY = ("route", "part_w3", "part_b3")
CLOUD_GROUPS = 16    # groups of clouds whose weight-gradient partials are summed in order
# the bf16 K6 forward's argmax keys: the low ARGMAX_ROW_BITS bits hold kRowMask - row
# (csrc/encoder_tail_common.cuh: kRowBits, kRowMask)
ARGMAX_ROW_BITS = 16
ARGMAX_MAX_ROWS = 1 << ARGMAX_ROW_BITS
_ROW_MASK = ARGMAX_MAX_ROWS - 1
SPLIT_ROWS = 4096    # K rows per range of the dW3 product, at most 128 ranges
K5B_COLS = 64        # dx columns a block of the bf16 K5 backward's dx pass owns (stnbwd::kCols)

_P = ctypes.c_void_p
_I = ctypes.c_int


# ---- plain versions -----------------------------------------------------------

def max_argmax(h):
    """(N, P, C) -> (max over P (N, C) f32, lowest row attaining it (N, C) int32)."""
    P = h.shape[1]
    m = h.amax(dim=1, keepdim=True)
    rows = torch.arange(P, device=h.device, dtype=torch.int32).view(1, P, 1)
    idx = torch.where(h == m, rows, P).amin(dim=1)
    return m[:, 0].float(), idx


def argmax_key(v, rows):
    """The bf16 K6 forward's key of each candidate (value v, point row):
    v (any shape) holds bf16 values in float32, rows broadcasts against it
    -> int64 keys in [0, 2**32), as `csrc/encoder_tail_common.cuh::fold_argmax`
    builds them: the high 16 bits order v with -0 equal to +0 (`order2`), the
    low bits are _ROW_MASK - row, so the larger key is the larger value, then
    the lower row. Raises for a value that is not a bf16 value."""
    u = v.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    if (u & _ROW_MASK).any():
        raise ValueError("argmax_key: the keys order bf16 values; got f32 values beyond bf16")
    order = torch.where(u >= 2**31, 2**31 - (u & 0x7FFFFFFF), u | 2**31)
    return (order & ~_ROW_MASK) | (_ROW_MASK - rows)


def max_argmax_keyed(h):
    """Plain version of the bf16 K6 forward's fold: (N, P, C) rounded bf16
    values (in any float type) -> the largest key of each (cloud, channel)
    over P, decoded as (max (N, C) f32, its lowest row (N, C) int32).
    P <= ARGMAX_MAX_ROWS."""
    P = h.shape[1]
    rows = torch.arange(P, device=h.device).view(1, P, 1)
    key = argmax_key(h, rows).amax(dim=1)
    order = key & ~_ROW_MASK
    bits = torch.where(order >= 2**31, order - 2**31, (2**31 - order) | 2**31)
    out = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)
    return out, (_ROW_MASK - (key & _ROW_MASK)).to(torch.int32)


def _rows_at(t, idx):
    """t (N, P, K), idx (N, C) -> t[n, idx[n, c], :] as (N, C, K)."""
    return torch.gather(t, 1, idx.long()[:, :, None].expand(-1, -1, t.shape[2]))


def _route(rows, idx, P):
    """rows (N, C, K) -> (N, P, K) f32 with rows[n, c] added onto row idx[n, c]."""
    N, _, K = rows.shape
    out = torch.zeros(N, P, K, device=rows.device, dtype=torch.float32)
    return out.scatter_add_(1, idx.long()[:, :, None].expand(-1, -1, K), rows)


def dense_relu_max_fwd_plain(x, w, b, cdt):
    """Plain K5 forward: materialises the (N, P, Cout) activation."""
    return max_argmax(dense(x, w, b, cdt, act=True))


def dense_relu_max_fwd_keyed_plain(x, w, b, cdt):
    """Plain version of the bf16 K5 forward's fold, for tests and checks:
    the ReLU'd rounded activation keyed and folded as `max_argmax_keyed`
    does. P <= ARGMAX_MAX_ROWS."""
    return max_argmax_keyed(dense(x, w, b, cdt, act=True))


def dense_relu_max_bwd_plain(x, w, b, idx, d_out, cdt):
    """Plain K5 backward -> (dx (N, P, Cin), dW (Cout, Cin), db (Cout)), f32."""
    wc = w.to(cdt).float()
    xr = _rows_at(x.to(cdt), idx).float()                           # (N, C, Cin)
    pre = (xr * wc).sum(dim=2) + b.float()                          # f32 product, f32 bias
    d = torch.where(pre > 0, d_out.float(), 0.0).to(cdt).float()    # (N, C)
    dx = _route(d[:, :, None] * wc, idx, x.shape[1])
    return dx, torch.einsum("nc,nck->ck", d, xr), d.sum(dim=0)


def dense_relu_dense_max_fwd_plain(x, w3, b3, w4, b4, cdt):
    """Plain K6 forward: materialises both activations."""
    return max_argmax(dense(dense(x, w3, b3, cdt, act=True), w4, b4, cdt))


def route_rows(idx, d4):
    """The bf16 K6 backward's routing, as its routing pass writes it per cloud:
    idx (N, C) int, d4 (N, C) the rounded cotangent -> (chan (N, C): the
    channels of the live keys (d4 != 0) in (row, channel) order, then -1;
    seg (N, C + 1): the first key of each critical row, seg[n, count[n]] the
    live keys, then C; rows (N, C): the critical rows ascending, then -1;
    count (N,)), all int64."""
    N, C = idx.shape
    live = d4 != 0
    big = torch.iinfo(torch.int64).max
    keys = torch.where(live, idx.long() * C + torch.arange(C, device=idx.device), big)
    keys = keys.sort(dim=1).values
    live_sorted = keys != big
    row = torch.where(live_sorted, keys // C, -1)
    head = live_sorted.clone()
    head[:, 1:] &= row[:, 1:] != row[:, :-1]
    count = head.sum(dim=1)
    pos = torch.arange(C, device=idx.device).expand(N, C)
    first = torch.where(head, pos, C).sort(dim=1).values             # heads first, ascending
    seg = torch.cat([first, torch.full((N, 1), C, device=idx.device)], dim=1)
    seg.scatter_(1, count[:, None], live_sorted.sum(dim=1, keepdim=True))
    has_row = pos < count[:, None]
    rows = torch.where(has_row, row.gather(1, first.clamp(max=C - 1)), -1)
    return torch.where(live_sorted, keys % C, -1), seg, rows, count


def dense_relu_dense_max_bwd_plain(x, w3, b3, w4, b4, idx, d_out, cdt):
    """Plain K6 backward -> (dx, dW3, db3, dW4, db4), f32; b4 gives db4's shape only."""
    xc, w3c, w4c = x.to(cdt).float(), w3.to(cdt).float(), w4.to(cdt).float()
    h3p = xc @ w3c.T + b3.float()                                   # (N, P, C3) f32, unrounded
    h3 = torch.relu(h3p).to(cdt).float()
    d4 = d_out.to(cdt).float()                                      # conv4 has no ReLU
    dw4 = torch.einsum("nc,ncj->cj", d4, _rows_at(h3, idx))
    d_h3 = _route(d4[:, :, None] * w4c, idx, x.shape[1])
    d_h3 = torch.where(h3p > 0, d_h3, 0.0).to(cdt).float()
    dw3 = torch.einsum("npj,npk->jk", d_h3, xc)
    return d_h3 @ w3c, dw3, d_h3.sum(dim=(0, 1)), dw4, d4.sum(dim=0).reshape(b4.shape)


def _critical_keys(idx, d):
    """The live keys of `route_rows(idx, d)` as flat lists over all clouds ->
    (cloud and point row of each critical row (R,), each live key's critical
    row in that list, its channel and its d (K,)), keys in routing order."""
    N, C = idx.shape
    chan, seg, rows, count = route_rows(idx, d)
    live, has_row = chan >= 0, rows >= 0
    cloud = torch.arange(N, device=idx.device)[:, None].expand(N, C)
    key_pos = torch.arange(C, device=idx.device).expand(N, C)
    seg_of_key = torch.searchsorted(seg[:, :-1].contiguous(), key_pos.contiguous(), right=True) - 1
    offset = torch.cumsum(count, 0) - count                           # first critical row of a cloud
    key_d = d.gather(1, chan.clamp(min=0))[live]
    return (cloud[has_row], rows[has_row], (offset[:, None] + seg_of_key)[live], chan[live], key_d)


def dense_relu_max_bwd_critical_plain(x, w, b, idx, d_out, cdt):
    """Plain K5 backward in the bf16 kernel's order: the gate per (cloud,
    channel) on its argmax row, the routing of the gated d (`route_rows`), per
    critical row the f32 sum over its segment in key order, rounded once to
    x's dtype, zero on every other row; dW and db from the live keys' critical
    rows -> (dx in x's dtype, dW (Cout, Cin), db (Cout) f32)."""
    wc = w.to(cdt).float()
    N, P, cin = x.shape
    xc = x.to(cdt)
    pre = (_rows_at(xc, idx).float() * wc).sum(dim=2) + b.float()    # f32 product, f32 bias
    d = torch.where(pre > 0, d_out.float(), 0.0).to(cdt).float()
    crit_cloud, crit_row, key_row, key_chan, key_d = _critical_keys(idx, d)
    g = torch.zeros(crit_row.numel(), cin, device=x.device)
    g.index_add_(0, key_row, key_d[:, None] * wc[key_chan])
    dx = torch.zeros(N, P, cin, device=x.device, dtype=x.dtype)
    dx[crit_cloud, crit_row] = g.to(x.dtype)
    xr = xc[crit_cloud, crit_row].float()                             # (R, cin)
    dw = torch.zeros(w.shape[0], cin, device=x.device).index_add_(0, key_chan,
                                                                   key_d[:, None] * xr[key_row])
    return dx, dw, torch.zeros(w.shape[0], device=x.device).index_add_(0, key_chan, key_d)


def dense_relu_dense_max_bwd_critical_plain(x, w3, b3, w4, b4, idx, d_out, cdt):
    """Plain K6 backward in the bf16 kernel's order, on the critical rows only:
    route (`route_rows`), g per critical row as a sum over its segment, the
    gate, then dx, dW3 and dW4 from those rows -> (dx, dW3, db3, dW4, db4), f32."""
    xc, w3c, w4c = x.to(cdt).float(), w3.to(cdt).float(), w4.to(cdt).float()
    N, P, cin = x.shape
    C = idx.shape[1]
    d4 = d_out.to(cdt).float()
    crit_cloud, crit_row, key_row, key_chan, key_d = _critical_keys(idx, d4)
    g = torch.zeros(crit_row.numel(), w4.shape[1], device=x.device)
    g.index_add_(0, key_row, key_d[:, None] * w4c[key_chan])
    xr = xc[crit_cloud, crit_row]                                     # (R, cin)
    h3p = xr @ w3c.T + b3.float()
    d_h3 = torch.where(h3p > 0, g.to(cdt).float(), 0.0)
    dx = torch.zeros(N, P, cin, device=x.device)
    dx[crit_cloud, crit_row] = d_h3 @ w3c
    h3 = torch.relu(h3p).to(cdt).float()
    dw4 = torch.zeros(C, w4.shape[1], device=x.device)
    dw4.index_add_(0, key_chan, key_d[:, None] * h3[key_row])
    return dx, d_h3.T @ xr, d_h3.sum(dim=0), dw4, d4.sum(dim=0).reshape(b4.shape)


# ---- kernels -------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("encoder_epilogue_train")
    lib.catre_dense_relu_max_train_fwd.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.catre_dense_relu_dense_max_train_fwd.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.catre_dense_relu_max_train_bwd.argtypes = [_P] * 12 + [_I] * 8 + [_P]
    lib.catre_dense_relu_dense_max_train_bwd.argtypes = [_P] + [_I] * 11 + [_P]
    lib.catre_k6_bwd_smem.argtypes = [_I] * 4
    lib.catre_k5_bwd_smem.argtypes = [_I] * 3
    lib.catre_k6_route_stride.argtypes = [_I]
    lib.catre_tail_smem.argtypes = [_I] * 2
    for fn in (lib.catre_dense_relu_max_train_fwd, lib.catre_dense_relu_dense_max_train_fwd,
               lib.catre_dense_relu_max_train_bwd, lib.catre_dense_relu_dense_max_train_bwd,
               lib.catre_dense_relu_dense_max_train_bwd_slots, lib.catre_k6_bwd_smem,
               lib.catre_k6_route_stride, lib.catre_tail_smem, lib.catre_k5_fwd_chunks,
               lib.catre_k5_fwd_smem, lib.catre_k5_bwd_smem):
        fn.restype = _I
    if lib.catre_dense_relu_dense_max_train_bwd_slots() != len(K6_BWD_SLOTS):
        raise _build.KernelBuildError(
            "encoder_epilogue_train: the library's pointer slots differ from K6_BWD_SLOTS")
    return lib


def _operands(name, x, cdt, shapes, f32=()):
    """Validate a kernel call: x (N, P, Cin) in `cdt` on a CUDA device, each
    (tensor, shape) of `shapes` of that shape, each of `f32` float32,
    everything contiguous on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {cdt} is not float32 or bfloat16")
    if x.dtype != cdt or x.dim() != 3:
        raise ValueError(f"{name}: x must be (N, P, C) {cdt}, got {tuple(x.shape)} {x.dtype}")
    bad = [tuple(t.shape) for t, shape in shapes if tuple(t.shape) != tuple(shape)]
    if bad:
        raise ValueError(f"{name}: shapes {bad} do not fit x {tuple(x.shape)}")
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError(f"{name}: gradients, weights and biases must be float32")
    _build.cuda_inputs(name, x, *(t for t, _ in shapes))


def _cast(x, cdt, weights, biases=()):
    """(weights in cdt, biases rounded to cdt as f32), contiguous on x's device."""
    with span("catre.op.pack"):
        return ([w.detach().to(device=x.device, dtype=cdt).contiguous() for w in weights],
                [b.detach().to(device=x.device, dtype=cdt).float().contiguous() for b in biases])


def k6_bwd_schedule(n, chid, cout, n_sms):
    """Grids of the bf16 K6 backward's passes on `n_sms` SMs -> (persistent
    blocks of the cloud pass, groups of clouds of the dW3 pass (chid / 64
    blocks a group: it keeps 64 columns of W4 resident), groups of the dW4
    pass ((cout / 128) x (chid / 128) blocks a group)): each fills the SMs at
    most once, with at least one group and no more groups than clouds."""
    return (min(n, n_sms), max(1, min(n, n_sms // (chid // 64))),
            max(1, min(n, n_sms // ((chid // 128) * (cout // 128)))))


def _check_routing(name, P, cout):
    if P * cout >= 2 ** 31:
        raise ValueError(f"{name}: P x Cout = {P} x {cout} overflows the routing keys")


def _check_argmax_rows(name, P):
    if not 1 <= P <= ARGMAX_MAX_ROWS:
        raise ValueError(f"{name}: the bf16 kernel's argmax keys hold rows 0 .. "
                         f"{ARGMAX_MAX_ROWS - 1}, got P = {P}")


def dense_relu_max_fwd(x, w, b, cdt):
    """K5 forward: x (N, P, Cin) in cdt, w (Cout, Cin), b (Cout) ->
    (max over P of relu(x @ w^T + b) (N, Cout) f32, idx (N, Cout) int32). In
    bf16 on the card: K2's limits (Cin 64 or 128, x on a 16-byte boundary)
    and 1 <= P <= ARGMAX_MAX_ROWS."""
    if x.device.type == "cpu":
        return dense_relu_max_fwd_plain(x, w, b, cdt)
    with span("catre.op.K5.fwd"):
        return _dense_relu_max_fwd(x, w, b, cdt)


def _dense_relu_max_fwd(x, w, b, cdt):
    name = "dense_relu_max_train_fwd"
    _build.refuse_grad(name, "dense_relu_max_train (the autograd Function around it)", x, w, b)
    N, P, cin = x.shape if x.dim() == 3 else (0, 0, 0)
    cout = w.shape[0]
    _operands(name, x, cdt, [(w, (cout, cin)), (b, (cout,))])
    _check_widths(name, cin, cout)
    (wc,), (bc,) = _cast(x, cdt, [w], [b])
    grid = 0
    if cdt == torch.bfloat16:
        check_k2_bf16(name, x, cin)
        _check_argmax_rows(name, P)
        grid, _ = stn_tail_grid(N, cout, _sm_count(x.device.index), _lib().catre_k5_fwd_chunks())
    out = torch.empty(N, cout, device=x.device, dtype=torch.float32)
    idx = torch.empty(N, cout, device=x.device, dtype=torch.int32)
    rc = _lib().catre_dense_relu_max_train_fwd(
        x.data_ptr(), wc.data_ptr(), bc.data_ptr(), out.data_ptr(), idx.data_ptr(), N, P, cin,
        cout, int(cdt == torch.bfloat16), grid, _build.stream_handle(x.device))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out, idx


def dense_relu_dense_max_fwd(x, w3, b3, w4, b4, cdt):
    """K6 forward -> (max over P of (relu(x @ w3^T + b3) @ w4^T + b4) (N, C4)
    f32, idx (N, C4) int32). In bf16 on the card: K1's limits (widths at most
    128 -> 512 -> 4096, x on a 16-byte boundary) and 1 <= P <= ARGMAX_MAX_ROWS."""
    if x.device.type == "cpu":
        return dense_relu_dense_max_fwd_plain(x, w3, b3, w4, b4, cdt)
    with span("catre.op.K6.fwd"):
        return _dense_relu_dense_max_fwd(x, w3, b3, w4, b4, cdt)


def _dense_relu_dense_max_fwd(x, w3, b3, w4, b4, cdt):
    name = "dense_relu_dense_max_train_fwd"
    _build.refuse_grad(name, "dense_relu_dense_max_train (the autograd Function around it)", x,
                       w3, b3, w4, b4)
    N, P, cin = x.shape if x.dim() == 3 else (0, 0, 0)
    chid, cout = w3.shape[0], w4.shape[0]
    _operands(name, x, cdt, [(w3, (chid, cin)), (b3, (chid,)), (w4, (cout, chid)), (b4, (cout,))])
    _check_widths(name, cin, chid, cout)
    (w3c, w4c), (b3c, b4c) = _cast(x, cdt, [w3, w4], [b3, b4])
    if cdt == torch.bfloat16:
        check_k1_bf16(name, x, cin, chid, cout)
        _check_argmax_rows(name, P)
        w3c, w4c = pack_panels(w3c), pack_panels(w4c)
    out = torch.empty(N, cout, device=x.device, dtype=torch.float32)
    idx = torch.empty(N, cout, device=x.device, dtype=torch.int32)
    rc = _lib().catre_dense_relu_dense_max_train_fwd(
        x.data_ptr(), w3c.data_ptr(), b3c.data_ptr(), w4c.data_ptr(), b4c.data_ptr(),
        out.data_ptr(), idx.data_ptr(), N, P, cin, chid, cout, int(cdt == torch.bfloat16),
        _build.stream_handle(x.device))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out, idx


def k5_bwd_grid(n, cin, n_sms):
    """Persistent blocks of the bf16 K5 backward's dx pass on `n_sms` SMs:
    cin / K5B_COLS column chunks, each walked by the same number of blocks,
    at most one block per SM and per (cloud, chunk), at least one per chunk."""
    chunks = cin // K5B_COLS
    return chunks * max(1, min(n, n_sms // chunks))


def dense_relu_max_bwd(x, w, b, idx, d_out, cdt):
    """K5 backward: x (N, P, Cin) in cdt, w (Cout, Cin) and b (Cout) f32, idx
    (N, Cout) int32 from the forward, d_out (N, Cout) f32 -> (dx (N, P, Cin)
    in x's dtype, dW (Cout, Cin), db (Cout) f32). In bf16 on the card: K2's
    limits (Cin 64 or 128, x on a 16-byte boundary) and W's 64-column chunk
    with two routing rows in a block's shared memory."""
    if x.device.type == "cpu":
        dx, dw, db = dense_relu_max_bwd_plain(x, w, b, idx, d_out, cdt)
        return dx.to(x.dtype), dw, db
    with span("catre.op.K5.bwd"):
        return _dense_relu_max_bwd(x, w, b, idx, d_out, cdt)


def _dense_relu_max_bwd(x, w, b, idx, d_out, cdt):
    name = "dense_relu_max_train_bwd"
    N, P, cin = x.shape if x.dim() == 3 else (0, 0, 0)
    cout = w.shape[0]
    _operands(name, x, cdt, [(w, (cout, cin)), (b, (cout,)), (idx, (N, cout)),
                             (d_out, (N, cout))], f32=(w, b, d_out))
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    _check_widths(name, cin, cout)
    _check_routing(name, P, cout)
    if cdt == torch.bfloat16:
        check_k2_bf16(name, x, cin)
        smem = _lib().catre_k5_bwd_smem(cin, cout, 1)
        if smem > _build.SMEM_LIMIT:
            raise ValueError(f"{name}: bf16 width {cout} needs {smem} bytes of shared memory (W's "
                             f"64-column chunk and two routing rows resident), above a block's "
                             f"{_build.SMEM_LIMIT}")
    outs = k5_bwd_launch(_lib(), x, w, b, idx, d_out, cdt)
    LAUNCHES[name] += 1
    return outs


def k5_bwd_launch(lib, x, w, b, idx, d_out, cdt):
    """One launch of `lib`'s K5 backward on checked operands: allocates the
    outputs and the build's scratch, raises on a launch error; -> (dx, dW,
    db). The wrapper above passes the library it builds; the probe tool a
    diagnostic build of the same source."""
    N, P, cin = x.shape
    cout = w.shape[0]
    bf16 = cdt == torch.bfloat16
    (wc,), _ = _cast(x, cdt, [w])
    dev = x.device
    groups = min(N, CLOUD_GROUPS)
    n_part = groups * cout * (cin + 1)
    grid, route = 0, None
    if bf16:    # one buffer: the partials of dW and db, then (once summed) the routing rows
        stride = lib.catre_k6_route_stride(cout)
        scratch = torch.empty(max(n_part, N * stride), device=dev, dtype=torch.float32)
        route = scratch[:N * stride].view(torch.int32)
        grid = k5_bwd_grid(N, cin, _sm_count(dev.index))
    else:
        scratch = torch.empty(n_part, device=dev, dtype=torch.float32)
    part_w, part_b = scratch[:groups * cout * cin], scratch[groups * cout * cin:n_part]
    d = torch.empty(N, cout, device=dev, dtype=torch.float32)
    dx = torch.empty(N, P, cin, device=dev, dtype=x.dtype)
    dw = torch.empty(cout, cin, device=dev, dtype=torch.float32)
    db = torch.empty(cout, device=dev, dtype=torch.float32)
    rc = lib.catre_dense_relu_max_train_bwd(
        x.data_ptr(), wc.data_ptr(), b.data_ptr(), idx.data_ptr(), d_out.data_ptr(), d.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), None if route is None else route.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), N, P, cin, cout, _pow2(cout), groups, grid,
        int(bf16), _build.stream_handle(dev))
    _build.check(rc, "dense_relu_max_train_bwd")
    return dx, dw, db


def dense_relu_dense_max_bwd(x, w3, b3, w4, b4, idx, d_out, cdt):
    """K6 backward: weights and biases f32, idx (N, C4) int32 from the
    forward, d_out (N, C4) f32 -> (dx (N, P, Cin) in x's dtype, dW3 (C3, Cin),
    db3 (C3), dW4 (C4, C3), db4 (C4) f32)."""
    if x.device.type == "cpu":
        dx, *grads = dense_relu_dense_max_bwd_plain(x, w3, b3, w4, b4, idx, d_out, cdt)
        return (dx.to(x.dtype), *grads)
    with span("catre.op.K6.bwd"):
        return _dense_relu_dense_max_bwd(x, w3, b3, w4, b4, idx, d_out, cdt)


def _dense_relu_dense_max_bwd(x, w3, b3, w4, b4, idx, d_out, cdt):
    name = "dense_relu_dense_max_train_bwd"
    N, P, cin = x.shape if x.dim() == 3 else (0, 0, 0)
    chid, cout = w3.shape[0], w4.shape[0]
    _operands(name, x, cdt, [(w3, (chid, cin)), (b3, (chid,)), (w4, (cout, chid)), (b4, (cout,)),
                             (idx, (N, cout)), (d_out, (N, cout))], f32=(w3, b3, w4, b4, d_out))
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    _check_widths(name, cin, chid, cout)
    _check_routing(name, P, cout)
    bf16 = cdt == torch.bfloat16
    if bf16:
        if cin not in (64, 128):
            raise ValueError(f"{name}: the bf16 kernel takes 64 or 128 input channels, got {cin}")
        smem = max(_lib().catre_k6_bwd_smem(cin, chid, cout, k) for k in (0, 1))
        if smem > _build.SMEM_LIMIT:
            raise ValueError(f"{name}: bf16 widths {cin}->{chid}->{cout} need {smem} bytes of "
                             f"shared memory (W3, or 64 columns of W4, resident), above a "
                             f"block's {_build.SMEM_LIMIT}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: x must start on a 16-byte boundary (16-byte copies)")
    outs = k6_bwd_launch(_lib(), x, w3, b3, w4, idx, d_out, cdt)
    LAUNCHES[name] += 1
    return outs


def k6_bwd_launch(lib, x, w3, b3, w4, idx, d_out, cdt):
    """One launch of `lib`'s K6 backward on checked operands: allocates the
    outputs and the build's scratch, raises on a launch error; -> (dx, dW3,
    db3, dW4, db4). The wrapper above passes the library it builds; the probe
    tool a diagnostic build of the same source."""
    N, P, cin = x.shape
    chid, cout = w3.shape[0], w4.shape[0]
    bf16 = cdt == torch.bfloat16
    (w3c, w4c), _ = _cast(x, cdt, [w3, w4])
    dev = x.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*shape, device=dev, dtype=dtype)

    cin_pad = -(-cin // 128) * 128
    bufs = dict(x=x, w3=w3c, b3=b3, w4=w4c, idx=idx, dout=d_out, dx=empty(N, P, cin, dtype=x.dtype),
                dw3=empty(chid, cin), db3=empty(chid), dw4=empty(cout, chid), db4=empty(cout))
    if bf16:
        grid, splits, groups = k6_bwd_schedule(N, chid, cout, _sm_count(dev.index))
        bufs.update(route=empty(N, lib.catre_k6_route_stride(cout), dtype=torch.int32),
                    part_w3=empty(splits, chid, cin), part_b3=empty(splits, chid))
    else:
        grid, groups = 0, min(N, CLOUD_GROUPS)
        splits = max(1, min(128, -(-(N * P) // SPLIT_ROWS)))
        with span("catre.op.pack"):
            w3t = torch.zeros(cin_pad, chid, device=dev, dtype=cdt)   # W3^T, zero rows past cin
            w3t[:cin] = w3c.T
        bufs.update(w3t=w3t, dh3=empty(N, P, chid, dtype=cdt), pdb3=empty(N, chid),
                    gpart=empty(splits, chid, cin))
    bufs.update(part_w4=empty(groups, cout, chid), part_b4=empty(groups, cout))
    absent = K6_BWD_F32_ONLY if bf16 else K6_BWD_BF16_ONLY
    ptrs = (ctypes.c_void_p * len(K6_BWD_SLOTS))(*[None if n in absent else bufs[n].data_ptr()
                                                   for n in K6_BWD_SLOTS])
    rc = lib.catre_dense_relu_dense_max_train_bwd(
        ptrs, N, P, cin, cin_pad, chid, cout, _pow2(cout), groups, splits, grid, int(bf16),
        _build.stream_handle(dev))
    _build.check(rc, "dense_relu_dense_max_train_bwd")
    return bufs["dx"], bufs["dw3"], bufs["db3"], bufs["dw4"], bufs["db4"]


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# ---- autograd ------------------------------------------------------------------------

class DenseReluMaxTrain(torch.autograd.Function):
    """out (N, Cout) f32 = K5 forward(x in cdt, f32 w and b cast to cdt); the
    backward is K5 backward."""

    @staticmethod
    def forward(ctx, x, w, b, cdt):
        out, idx = dense_relu_max_fwd(x, w, b, cdt)
        ctx.save_for_backward(x, w, b, idx)
        ctx.cdt = cdt
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, w, b, idx = ctx.saved_tensors
        dx, dw, db = dense_relu_max_bwd(x, w.float(), b.float(), idx,
                                        d_out.float().contiguous(), ctx.cdt)
        return dx, dw, db, None


class DenseReluDenseMaxTrain(torch.autograd.Function):
    """out (N, C4) f32 = K6 forward; the backward is K6 backward."""

    @staticmethod
    def forward(ctx, x, w3, b3, w4, b4, cdt):
        out, idx = dense_relu_dense_max_fwd(x, w3, b3, w4, b4, cdt)
        ctx.save_for_backward(x, w3, b3, w4, b4, idx)
        ctx.cdt = cdt
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, w3, b3, w4, b4, idx = ctx.saved_tensors
        dx, dw3, db3, dw4, db4 = dense_relu_dense_max_bwd(
            x, w3.float(), b3.float(), w4.float(), b4.float(), idx, d_out.float().contiguous(),
            ctx.cdt)
        return dx, dw3, db3, dw4, db4, None


def dense_relu_max_train(h, w, b, cdt):
    """Differentiable K5: max over P of relu(h @ w^T + b) -> (N, Cout) f32."""
    return DenseReluMaxTrain.apply(h.to(cdt).contiguous(), w, b, cdt)


def dense_relu_dense_max_train(h, w3, b3, w4, b4, cdt):
    """Differentiable K6: max over P of (relu(h @ w3^T + b3) @ w4^T + b4)."""
    return DenseReluDenseMaxTrain.apply(h.to(cdt).contiguous(), w3, b3, w4, b4, cdt)


ENCODER_TAIL_TRAIN = (dense_relu_max_train, dense_relu_dense_max_train)
