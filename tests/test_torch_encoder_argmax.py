"""The bf16 K6 and K5 forwards' argmax folds (`csrc/encoder_tail_wgmma.cuh`
and `csrc/encoder_stn_tail_wgmma.cuh` with kIdx, keys of
`csrc/encoder_tail_common.cuh`) on the CPU, through their plain versions
`max_argmax_keyed` and `dense_relu_max_fwd_keyed_plain`, same numpy inputs.
K6:
  - against `max_argmax` (the port's per-row plain forward) bit-equal, and
    with it against the Pallas forward `_fwd_kernel_2` (what
    `dense_relu_dense_max_t` runs) in interpret mode, compiled without XLA's
    excess precision (which on the CPU skips the body's bf16 roundings): idx
    equal, out 1e-5, on tie-rich data: every point twice; exact-integer
    operands (x in {0, 1, 2}, weights in {-2 .. 2}, integer biases), whose f32
    sums are exact in any order while the bf16 roundings tie rows whose
    accumulators differ, at P = 1000 and P = 40, in bf16 and f32; random
    operands in f32 (the f32 build keeps the old body);
  - a channel whose maximum is -0 on some rows and +0 on others: the lowest
    of them, as the Pallas body's `blk == m` has it;
  - a hypothesis sweep of the key: its order is that of (value, -row) for
    bf16 values, -0 and +0 equal, every candidate above the empty key 0;
  - the key layout constants as the CUDA source spells them.
K5, whose keys are built after the ReLU (`relu_keys`: the bf16 bits of a
value at or above +0, no order image):
  - `dense_relu_max_fwd_keyed_plain` against `max_argmax` bit-equal, and
    with it against the Pallas forward `_fwd_kernel_1` in interpret mode
    (excess precision off): idx equal, out 1e-5, on exact-integer operands
    with a quarter of the channels negative on every row before the ReLU
    (bias -50: every row ties at 0, idx 0), every point twice, P = 1000 and
    40, bf16 and f32; random operands in f32;
  - pre-ReLU values -0, +0 and negative, which all tie at +0, and a -0 that
    must not key above a positive value;
  - a hypothesis sweep of the ReLU'd key against the order of (relu(v), -row);
  - the key as the CUDA source builds it (`max.s16x2` with 0, two byte
    permutes), modelled bit by bit on every bf16 pattern.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from catre_tpu.ops import pallas_encoder_epilogue_vjp as jax_vjp
from catre_tpu_torch.models.layers import dense
from catre_tpu_torch.ops import encoder_epilogue_train as train_ops

CSRC = Path(train_ops.__file__).resolve().parents[1] / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
JNP = {F32: jnp.float32, BF16: jnp.bfloat16}


def _case(kind, seed, n, p, widths=(128, 256, 384)):
    """(x (N, P, Cin), w3 (C3, Cin), b3, w4 (C4, C3), b4) float32 numpy, in the
    port's (out, in) layout: "integers" exact-integer operands, "normal"
    random ones; either with every point twice ("... twice")."""
    rng = np.random.default_rng(seed)
    cin, chid, cout = widths
    if kind.startswith("integers"):
        x = rng.integers(0, 3, size=(n, p, cin))
        w3, w4 = rng.integers(-2, 3, size=(chid, cin)), rng.integers(-2, 3, size=(cout, chid))
        b3, b4 = rng.integers(-8, 9, size=chid), rng.integers(-8, 9, size=cout)
    else:
        x = rng.normal(size=(n, p, cin)) * 0.3
        w3, w4 = rng.normal(size=(chid, cin)) * 0.1, rng.normal(size=(cout, chid)) * 0.1
        b3, b4 = rng.normal(size=chid) * 0.1, rng.normal(size=cout) * 0.1
    if kind.endswith("twice"):
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    return [a.astype(np.float32) for a in (x, w3, b3, w4, b4)]


def _pallas_fwd(case, cdt):
    """(out, idx) of the Pallas forward body in interpret mode, in `cdt`: K6's
    (`_fwd_kernel_2`) for a case of five arrays, K5's (`_fwd_kernel_1`) for
    (x, w, b). XLA on the CPU may drop a rounding to bf16 and keep the f32
    value (excess precision); compiled without that, it rounds where the body
    says."""
    def fwd(x, *wb):
        kernel = jax_vjp._fwd_kernel_2 if len(wb) == 4 else jax_vjp._fwd_kernel_1
        params = [a.T if a.ndim == 2 else a.reshape(1, -1) for a in wb]
        return jax_vjp._fwd_call(kernel, x, params, wb[-1].shape[0], jax_vjp._FWD_BLOCK, True,
                                 JNP[cdt])

    args = list(map(jnp.asarray, case))
    compiled = jax.jit(fwd).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out, idx = compiled(*args)
    return np.asarray(out), np.asarray(idx)


def _rounded(case, cdt):
    """The (N, P, C4) rounded activation of the port's plain K6 forward."""
    x, w3, b3, w4, b4 = map(torch.from_numpy, case)
    return dense(dense(x.to(cdt), w3, b3, cdt, act=True), w4, b4, cdt).float()


# random operands in f32 only: in bf16 XLA and PyTorch round some of their sums
# apart, where the integer cases hold bf16 exactly. The keyed fold is the bf16
# kernel's; in f32 (the old body) the per-row plain forward alone is held to Pallas.
@pytest.mark.parametrize("kind,n,p,cdt", [
    ("integers", 2, 1000, F32), ("integers", 2, 1000, BF16), ("integers", 3, 40, F32),
    ("integers", 3, 40, BF16), ("integers twice", 2, 40, F32), ("integers twice", 2, 40, BF16),
    ("normal twice", 3, 40, F32), ("normal", 2, 100, F32)])
def test_keyed_fold_matches_max_argmax_and_pallas(kind, n, p, cdt):
    case = _case(kind, 60 + n + p, n, p)
    h = _rounded(case, cdt)
    out, idx = train_ops.max_argmax(h)
    if cdt == BF16:
        out_k, idx_k = train_ops.max_argmax_keyed(h)
        assert out_k.dtype == F32 and idx_k.dtype == torch.int32
        assert torch.equal(out_k, out) and torch.equal(idx_k, idx)
    # the port's forward on the CPU is the per-row plain version
    xs = [torch.from_numpy(a) for a in case]
    fwd = train_ops.dense_relu_dense_max_fwd(xs[0].to(cdt), *xs[1:], cdt)
    assert torch.equal(fwd[0], out) and torch.equal(fwd[1], idx)
    ref_out, ref_idx = _pallas_fwd(case, cdt)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=0)
    if kind.endswith("twice"):
        assert idx.max() < p // 2                          # the lower of two equal rows


def test_integer_operands_tie_rows_whose_accumulators_differ():
    """The bf16 case above is the one K1's fold gets wrong: rows that tie after
    the two roundings while their f32 accumulators differ, where the row of
    the largest accumulator is not the lowest tied row."""
    case = _case("integers", 60 + 2 + 1000, 2, 1000)
    h = _rounded(case, BF16)
    _, idx = train_ops.max_argmax_keyed(h)
    x, w3, b3, w4, _ = map(torch.from_numpy, case)
    acc = torch.nn.functional.linear(dense(x.to(BF16), w3, b3, BF16, act=True).float(), w4)
    assert (acc.argmax(dim=1) != idx).sum() >= 5


def test_keyed_fold_holds_minus_zero_equal_to_plus_zero():
    """A channel whose max is -0 on some rows and +0 on others: the lowest of
    all of them, whichever sign it has, as `_per_cloud_max_argmax` (the
    Pallas body's max and argmax) returns it."""
    n, p, c = 2, 40, 4
    h = -torch.arange(1, n * p * c + 1, dtype=F32).view(n, p, c).bfloat16().float()
    h[0, [3, 11], 0], h[0, [5, 20], 0] = -0.0, 0.0      # -0 lowest
    h[0, [2, 30], 1], h[0, [7], 1] = 0.0, -0.0          # +0 lowest
    h[1, [9], 2], h[1, [4, 33], 2] = 0.0, -0.0          # -0 lowest, one +0 above
    h[1, :, 3] = -0.0                                    # every row -0
    out, idx = train_ops.max_argmax_keyed(h)
    ref_out, ref_idx = jax_vjp._per_cloud_max_argmax(jnp.asarray(h.numpy()).reshape(n * p, c), n, p)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert idx[0, 0] == 3 and idx[0, 1] == 2 and idx[1, 2] == 4 and idx[1, 3] == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))    # -0 == +0 here
    assert torch.equal(train_ops.max_argmax(h)[1], idx)
    with pytest.raises(ValueError, match="bf16"):             # the keys hold bf16 values only
        train_ops.max_argmax_keyed(h + 2.0 ** -10)


def _bf16(f):
    return torch.tensor([f], dtype=F32).bfloat16().float()


@settings(max_examples=300, deadline=None)
@given(a=st.floats(width=32, allow_nan=False), b=st.floats(width=32, allow_nan=False),
       ra=st.integers(0, train_ops.ARGMAX_MAX_ROWS - 1),
       rb=st.integers(0, train_ops.ARGMAX_MAX_ROWS - 1), same=st.booleans())
def test_argmax_key_orders_value_then_lower_row(a, b, ra, rb, same):
    va, vb = _bf16(a), (_bf16(a) if same else _bf16(b))
    ka, kb = (train_ops.argmax_key(v, r).item() for v, r in ((va, ra), (vb, rb)))
    fa, fb = va.item(), vb.item()
    assert 0 < ka < 2**32 and 0 < kb < 2**32                # above an empty table's 0
    want = (fa, -ra) < (fb, -rb)                            # -0 == +0 as floats
    assert (ka < kb) == want
    assert (ka == kb) == (fa == fb and ra == rb)
    # the decode gives the value back (+0 for -0) and the row
    out, idx = train_ops.max_argmax_keyed(va.view(1, 1, 1))
    assert out.item() == fa and idx.item() == 0
    if fa == 0:
        assert train_ops.argmax_key(torch.tensor([-0.0]), ra) == train_ops.argmax_key(
            torch.tensor([0.0]), ra)


def test_argmax_key_layout_matches_the_kernel_source():
    src = (CSRC / "encoder_tail_common.cuh").read_text()
    bits = int(re.search(r"constexpr int kRowBits = (\d+);", src).group(1))
    assert bits == train_ops.ARGMAX_ROW_BITS and 1 << bits == train_ops.ARGMAX_MAX_ROWS
    assert re.search(r"constexpr uint32_t kRowMask = \(1u << kRowBits\) - 1;", src)
    # the value's order, per 16-bit half: a negative 0x8000 - |v|, any other v | 0x8000,
    # as `argmax_key` here builds it on the high half of the float's bits
    assert "const uint32_t neg = (p >> 15) & 0x00010001u;" in src
    assert "return (p ^ (neg * 0x7FFFu | 0x80008000u)) + neg;" in src
    for half in range(2):        # the same order, modelled bit by bit on every bf16 pattern
        bits = np.arange(2**16, dtype=np.int64)
        p = bits << (16 * half)
        neg = (p >> 15) & 0x00010001
        img = (((p ^ (neg * 0x7FFF | 0x80008000)) + neg) >> (16 * half)) & 0xFFFF
        v = torch.from_numpy((bits << 16).astype(np.uint32).view(np.int32)).view(F32)
        finite = ~torch.isnan(v)
        want = train_ops.argmax_key(v[finite], 0).numpy() >> 16
        np.testing.assert_array_equal(img[finite.numpy()], want)
    # rows: kRowMask - row in the low bits of a winner's key
    assert "const uint32_t r0 = ok0 ? row_bits : 0u, r1 = ok1 ? row_bits - 8 : 0u;" in src
    # the kernel takes rows 0 .. kRowMask, the wrapper refuses larger P
    kernel = (CSRC / "encoder_tail_wgmma.cuh").read_text()
    assert "p > static_cast<int>(kRowMask) + 1" in kernel
    assert "kRowMask - r0" in kernel


# ---- K5: keys after the ReLU

def _k5_case(kind, seed, n, p, widths=(128, 256)):
    """(x (N, P, Cin), w (Cout, Cin), b) float32 numpy: "integers" exact-integer
    operands with every fourth channel's weights at or below 0 and its bias
    at -50 (negative on every row before the ReLU, so every row ties at 0),
    "normal" random ones; either with every point twice ("... twice")."""
    rng = np.random.default_rng(seed)
    cin, cout = widths
    if kind.startswith("integers"):
        x = rng.integers(0, 3, size=(n, p, cin))
        w, b = rng.integers(-2, 3, size=(cout, cin)), rng.integers(-8, 9, size=cout)
        w[::4], b[::4] = -np.abs(w[::4]), -50
    else:
        x = rng.normal(size=(n, p, cin)) * 0.3
        w, b = rng.normal(size=(cout, cin)) * 0.1, rng.normal(size=cout) * 0.1
    if kind.endswith("twice"):
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    return [a.astype(np.float32) for a in (x, w, b)]


@pytest.mark.parametrize("kind,n,p,cdt", [
    ("integers", 2, 1000, F32), ("integers", 2, 1000, BF16), ("integers", 3, 40, F32),
    ("integers", 3, 40, BF16), ("integers twice", 2, 40, F32), ("integers twice", 2, 40, BF16),
    ("normal twice", 3, 40, F32), ("normal", 2, 100, F32)])
def test_k5_keyed_fold_matches_max_argmax_and_pallas(kind, n, p, cdt):
    case = _k5_case(kind, 80 + n + p, n, p)
    x, w, b = map(torch.from_numpy, case)
    h = dense(x.to(cdt), w, b, cdt, act=True).float()
    out, idx = train_ops.max_argmax(h)
    if cdt == BF16:
        keyed = train_ops.dense_relu_max_fwd_keyed_plain(x.to(cdt), w, b, cdt)
        assert torch.equal(keyed[0], out) and torch.equal(keyed[1], idx)
    fwd = train_ops.dense_relu_max_fwd(x.to(cdt), w, b, cdt)     # the CPU runs the plain version
    assert torch.equal(fwd[0], out) and torch.equal(fwd[1], idx)
    ref_out, ref_idx = _pallas_fwd(case, cdt)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=0)
    if kind.startswith("integers"):
        assert (idx[:, ::4] == 0).all() and (out[:, ::4] == 0).all()
        assert (h[:, :, 1::4] == 0).any()       # rows below zero elsewhere tie at 0 too
    if kind.endswith("twice"):
        assert idx.max() < p // 2


def relu_argmax_key(v, rows):
    """The bf16 K5 forward's key of a candidate as `relu_keys` builds it from
    the rounded value v before the ReLU (bf16 values in float32): the bf16
    bits after a signed 16-bit max with 0 (negative values and -0 become +0),
    above kRowMask - row -> int64 keys in [0, 2**32)."""
    u = v.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(u >= 2**31, 0, u >> 16)
    return (bits << 16) | (train_ops.ARGMAX_MAX_ROWS - 1 - rows)


def test_k5_key_holds_minus_zero_and_negatives_as_plus_zero():
    """Before the ReLU: -0, +0 and negative values all tie at +0, so the lowest
    of them wins where nothing is positive; a -0 never keys above a positive
    value. The largest ReLU'd key decodes to what `_per_cloud_max_argmax`
    (the Pallas body's max and argmax) returns on jnp.maximum(h, 0)."""
    n, p, c = 2, 40, 4
    pre = -torch.arange(1, n * p * c + 1, dtype=F32).view(n, p, c).bfloat16().float()
    pre[0, 0, 0], pre[0, 7, 0] = -0.0, 1.0              # -0 at row 0, a positive row 7
    pre[0, [3, 11], 1] = -0.0                           # every row <= 0: row 0
    pre[1, [0, 9], 2], pre[1, 4, 2] = 0.0, -0.0         # +0 at row 0
    pre[1, 20, 3] = 2.0 ** -100                         # one tiny positive value
    rows = torch.arange(p).view(1, p, 1)
    key = relu_argmax_key(pre, rows).amax(dim=1)
    out = (key >> 16 << 16).to(torch.int32).view(F32)
    idx = (train_ops.ARGMAX_MAX_ROWS - 1 - (key & 0xFFFF)).to(torch.int32)
    relu = jnp.maximum(jnp.asarray(pre.numpy()), 0).reshape(n * p, c)
    ref_out, ref_idx = jax_vjp._per_cloud_max_argmax(relu, n, p)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    assert idx[0, 0] == 7 and out[0, 0] == 1 and idx[0, 1] == 0 and idx[1, 2] == 0
    assert idx[1, 3] == 20
    h = torch.relu(pre)
    assert all(torch.equal(a, b) for a, b in zip(train_ops.max_argmax_keyed(h), (out, idx)))


@settings(max_examples=300, deadline=None)
@given(a=st.floats(width=32, allow_nan=False), b=st.floats(width=32, allow_nan=False),
       ra=st.integers(0, train_ops.ARGMAX_MAX_ROWS - 1),
       rb=st.integers(0, train_ops.ARGMAX_MAX_ROWS - 1))
def test_relu_key_orders_relu_value_then_lower_row(a, b, ra, rb):
    va, vb = _bf16(a), _bf16(b)
    ka, kb = (relu_argmax_key(v, r).item() for v, r in ((va, ra), (vb, rb)))
    fa, fb = max(va.item(), 0.0), max(vb.item(), 0.0)
    assert 0 <= ka < 2**32 and 0 <= kb < 2**32
    assert (ka < kb) == ((fa, -ra) < (fb, -rb))
    assert (ka == kb) == (fa == fb and ra == rb)
    # after the ReLU the key orders as the K6 key does
    if (fa, ra) != (fb, rb):
        k6a, k6b = (train_ops.argmax_key(torch.tensor([f]), r).item() for f, r in ((fa, ra), (fb, rb)))
        assert (ka < kb) == (k6a < k6b)


def test_relu_key_layout_matches_the_kernel_source():
    src = (CSRC / "encoder_tail_common.cuh").read_text()
    assert 'asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(p), "r"(0u));' in src
    assert "return __byte_perm(p, r, 0x1054);" in src and "return __byte_perm(p, r, 0x3254);" in src
    assert "return __uint_as_float(key & ~kRowMask);" in src
    # every bf16 pattern in either half of a pair, through the same instructions in numpy
    bits = np.arange(2**16, dtype=np.int64)
    relu = np.where(bits >= 0x8000, 0, bits)                  # max.s16x2 with 0, one half
    r = 0x1234
    for half, sel in ((0, 0x1054), (1, 0x3254)):
        pair = relu << (16 * half)
        src_bytes = [(pair >> (8 * i)) & 0xFF for i in range(4)] + [(r >> (8 * i)) & 0xFF
                                                                    for i in range(4)]
        key = sum(src_bytes[(sel >> (4 * i)) & 0xF] << (8 * i) for i in range(4))
        v = torch.from_numpy((bits << 16).astype(np.uint32).view(np.int32)).view(F32)
        finite = ~torch.isnan(v)
        want = relu_argmax_key(v[finite], train_ops.ARGMAX_MAX_ROWS - 1 - r).numpy()
        np.testing.assert_array_equal(key[finite.numpy()], want)
    # rows: kRowMask - row in the kernel, rows at or past P keyed 0; P <= kRowMask + 1
    kernel = (CSRC / "encoder_stn_tail_wgmma.cuh").read_text()
    assert "tail::kRowMask - static_cast<uint32_t>(r)" in kernel
    assert "lo0 = ok0 ? lo0 : 0u;" in src
    assert "p > static_cast<int>(tail::kRowMask) + 1" in kernel
