"""What surrounds the Hopper K4 (`csrc/rot_head_bwd.cu`) and can be held on the CPU:
  - the derivative of GELU the bf16 kernel evaluates (`gelu7_grad`: the erf
    polynomial and two constants read out of `csrc/rot_head_wgmma.cuh`),
    evaluated in float32 as the kernel does, against `torch.autograd` of the
    exact-erf GELU of the plain version: 1e-6 absolute;
  - the address arithmetic of `csrc/wgmma_tile.cuh::product_n64`, modelled in
    numpy: a weight staged as swizzled K-panels, read MN-major (transposed)
    through the canonical 128-byte-swizzle layout from the start addresses
    the kernel gives, yields W[k, n]; read K-major by 64-row quarters it
    yields W[n, k]; and the reduce-and-scatter of `column_sums` leaves every
    column's sum with the lane that owns its table slot; the column order of
    the bf16 operand arrays (`stored_column`, read out of
    `csrc/rot_head_bwd.cu`) is its own inverse, stays inside 32 columns and
    makes the eight registers a thread holds of two k-steps 16 contiguous bytes;
  - the split of the work by head: `rot_head_bwd_twin` with d_out of one head
    at a time gives that head's parameter gradients and a d_pf partial, and
    the two partials add up to the joint d_pf to f32 rounding, at a point
    count a 64-point tile does not divide with the cloud / keypoint boundary
    inside a tile;
  - `rot_head_train` on CPU tensors (K3's and K4's plain versions) against
    the JAX package's `fused_rot_head_train` in interpret mode at such point
    counts, value 1e-3, gradients 5e-4 + 1e-3 relative;
  - `wgmma_tn` on CPU tensors (its plain version) against float64.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.ops.pallas_heads_vjp import fused_rot_head_train
from catre_tpu_torch.models.layers import gelu_exact
from catre_tpu_torch.ops import rot_head as rot_ops
from catre_tpu_torch.ops import rot_head_train as train_ops
from catre_tpu_torch.utils.convert import params_from_jax

from test_torch_kernels import _np_tree, _rot_head_case, _t
from test_torch_rot_head import _erf7, _read_panel, _stage_weight

CSRC = Path(rot_ops.__file__).resolve().parents[1] / "csrc"
F32 = torch.float32


# ---- GELU' of the kernel ------------------------------------------------------------------

def _constant(name):
    src = (CSRC / "rot_head_wgmma.cuh").read_text()
    return np.float32(re.search(rf"constexpr float {name}\s*=\s*([0-9.eE+-]+)f;", src).group(1))


def _gelu7_grad(x):
    """`gelu7_grad` in float32 (numpy rounds each product and sum where the
    card fuses them, and its exp2 is exact where the card's is approximate)."""
    half, one = np.float32(0.5), np.float32(1.0)
    erfc = one - np.abs(_erf7(x * np.float32(0.70710678118654752440)))
    cdf = half + np.copysign(half - half * erfc, x)
    q = np.exp2(-_constant("kHalfLog2E") * x * x).astype(np.float32)
    return (_constant("kInvSqrt2Pi") * x * q + cdf).astype(np.float32), (x * cdf).astype(np.float32)


def test_gelu_derivative_of_the_kernel_is_autograd_of_exact_gelu():
    assert abs(_constant("kHalfLog2E") - 0.5 * np.log2(np.e)) < 1e-7
    assert abs(_constant("kInvSqrt2Pi") - 1.0 / np.sqrt(2.0 * np.pi)) < 1e-7
    x = np.linspace(-12.0, 12.0, 400_001).astype(np.float32)
    xt = torch.from_numpy(x).double().requires_grad_()
    value = gelu_exact(xt)
    (exact,) = torch.autograd.grad(value.sum(), xt)
    dg, g = _gelu7_grad(x)
    assert np.abs(dg - exact.numpy()).max() <= 1e-6
    assert (np.abs(g - value.detach().numpy()) <= 2e-7 * np.maximum(1.0, np.abs(x))).all()


# ---- csrc/wgmma_tile.cuh::product_n64 in numpy ------------------------------------------------

def _swizzle128(byte):
    """The 128-byte swizzle on a byte offset from a 1024-byte boundary: the
    16-byte chunk index (bits 4..6) XOR the 128-byte row index (bits 7..9)."""
    return byte ^ (((byte >> 7) & 7) << 4)


def _read_mn(staged, start, n, k, sbo=1024):
    """Element (k, n) of the 16 x 64 operand a transposed k-step reads from
    byte `start` on: N runs along a 128-byte row, K along rows, eight rows
    `sbo` bytes apart a group (the MN-major canonical layout, one atom wide)."""
    assert start % 1024 == 0
    return staged[_swizzle128(start + (k // 8) * sbo + (k % 8) * 128 + n * 2) // 2]


@pytest.mark.parametrize("n_rows,k_cols", [(256, 256), (256, 64)])
def test_staged_weight_read_transposed(n_rows, k_cols):
    """d = a @ W for W (out, in) staged as for a @ W^T: panel kp holds the
    product's 64 columns 64 kp .., a k-step of 16 rows is 2048 bytes on."""
    w = np.arange(n_rows * k_cols, dtype=np.int64).reshape(n_rows, k_cols)
    staged = _stage_weight(w)
    rng = np.random.default_rng(1)
    for _ in range(500):
        kp, s = int(rng.integers(0, k_cols // 64)), int(rng.integers(0, n_rows // 16))
        k, n = int(rng.integers(0, 16)), int(rng.integers(0, 64))
        start = kp * n_rows * 128 + s * 2048          # panel kp, row 16 s: what the kernel passes
        assert _read_mn(staged, start, n, k) == w[16 * s + k, 64 * kp + n]


def test_staged_weight_read_by_quarters():
    """a @ W[64 q : 64 q + 64, :]^T: the K-major read of `_read_panel` from row
    64 q of the panel, 8192 bytes on, a multiple of the swizzle's 1024."""
    w = np.arange(256 * 64, dtype=np.int64).reshape(256, 64)
    staged = _stage_weight(w)
    assert (64 * 128) % 1024 == 0
    for q in range(4):
        for n, kk in ((0, 0), (5, 17), (63, 63), (31, 40)):
            assert _read_panel(staged, 256, 64 * q + n, kk) == w[64 * q + n, kk]
            assert _swizzle128((64 * q + n) * 128 + kk * 2) // 2 == (
                (64 * q + n) * 128 + (((kk // 8) ^ (n & 7)) << 4) + (kk % 8) * 2) // 2


def test_column_sums_leave_each_column_with_its_owner():
    """`column_sums`: lane (g, t) brings v[2 j + e] for column 8 j + 2 t + e
    (its two rows added); after three exchange steps lane g holds the sums
    over the eight row lanes of columns 8 g + 2 t + e = 2 lane + e."""
    rng = np.random.default_rng(2)
    vals = rng.integers(-50, 50, size=(8, 4, 16)).astype(np.float64)      # [g][t][2 j + e]
    cur = {(g, t): list(vals[g, t]) for g in range(8) for t in range(4)}
    for bit, n in ((4, 8), (2, 4), (1, 2)):
        nxt = {}
        for (g, t), v in cur.items():
            up, other = bool(g & bit), cur[g ^ bit, t]
            keep = v[n:] if up else v[:n]
            recv = other[n:] if up else other[:n]       # the partner sends what it does not keep
            nxt[g, t] = [a + b for a, b in zip(keep, recv)]
        cur = nxt
    for (g, t), v in cur.items():
        assert len(v) == 2
        for e in range(2):
            assert v[e] == vals[:, t, 2 * g + e].sum()
            assert 8 * g + 2 * t + e == 2 * (4 * g + t) + e


def _stored_column():
    """`stored_column` as the CUDA source spells it (the expression is Python's too)."""
    src = (CSRC / "rot_head_bwd.cu").read_text()
    body = re.search(r"constexpr int stored_column\(int c\) \{\s*return ([^;]+);", src).group(1)
    return lambda c: eval(body, {"c": c})      # noqa: S307 - the repository's own source


def test_stored_column_order_of_the_operand_arrays():
    stored = _stored_column()
    assert all(stored(stored(c)) == c and stored(c) // 32 == c // 32 for c in range(512))
    # A fragment: k-step s, register i holds columns 16 s + 8 (i // 2) + 2 t, + 1 of row
    # g (i even) or g + 8 (i odd). `store_fragment` writes, for a pair of k-steps k and
    # one row, registers [2 k][i], [2 k][i + 2], [2 k + 1][i], [2 k + 1][i + 2] as 16
    # bytes at stored column 32 k + 8 t; a quad's four pieces are 64 contiguous bytes.
    for k in range(8):
        for t in range(4):
            natural = [16 * s + 8 * half + 2 * t + e
                       for s in (2 * k, 2 * k + 1) for half in (0, 1) for e in (0, 1)]
            assert [stored(c) for c in natural] == list(range(32 * k + 8 * t, 32 * k + 8 * t + 8))


# ---- the work split by head ---------------------------------------------------------------

def _bwd_case(seed, b, p, k):
    pf, g_pcl, g_kps, params, head = _rot_head_case(seed, b, p, k)
    rng = np.random.default_rng(seed + 1)
    d_out = torch.from_numpy(rng.normal(size=(b, 6)).astype(np.float32))
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, F32, weight_dtype=F32)
        gterm = torch.stack([_t(g_pcl), _t(g_kps)], dim=1) @ pack.w_g.T
    return _t(pf), gterm, pack, d_out


@pytest.mark.parametrize("b,p,k", [(2, 100, 37), (2, 70, 64)])
def test_backward_splits_by_head(b, p, k):
    pf, gterm, pack, d_out = _bwd_case(51, b, p, k)
    joint = train_ops.rot_head_bwd(pf, gterm, pack, p, d_out)       # CPU: the plain version
    per_head = []
    for h in range(2):
        d_h = torch.zeros_like(d_out)
        d_h[:, 3 * h:3 * h + 3] = d_out[:, 3 * h:3 * h + 3]
        per_head.append(train_ops.rot_head_bwd_twin(pf, gterm, pack, p, d_h))
    scale = joint["pf"].abs().max().item()
    np.testing.assert_allclose((per_head[0]["pf"] + per_head[1]["pf"]).numpy(),
                               joint["pf"].numpy(), atol=1e-5 * scale, rtol=0)
    feat = rot_ops.FEAT
    for name in train_ops.GRAD_NAMES[1:]:
        want = joint[name]
        for h, other in ((0, 1), (1, 0)):
            got = per_head[h][name]
            if name in ("w1", "pw"):       # one leading row per head
                mine, rest = (got[h], want[h]), got[other]
            elif name == "neck":
                mine, rest = (got[3 * h:3 * h + 3], want[3 * h:3 * h + 3]), got[3 * other:3 * other + 3]
            elif name == "gterm":
                mine = (got[..., h * feat:(h + 1) * feat], want[..., h * feat:(h + 1) * feat])
                rest = got[..., other * feat:(other + 1) * feat]
            else:      # (512, ...) rows of the joint channels
                mine = (got[h * feat:(h + 1) * feat], want[h * feat:(h + 1) * feat])
                rest = got[other * feat:(other + 1) * feat]
            tol = 1e-5 * max(1.0, mine[1].abs().max().item())
            np.testing.assert_allclose(mine[0].numpy(), mine[1].numpy(), atol=tol, rtol=0,
                                       err_msg=f"{name} head {h}")
            assert rest.abs().max().item() == 0.0, f"{name}: head {h} reaches head {other}"


# ---- the training op against the JAX package ------------------------------------------------

@pytest.mark.parametrize("b,p,k", [(2, 100, 37), (2, 70, 64)])
def test_rot_head_train_on_cpu_matches_jax_at_ragged_point_counts(b, p, k):
    pf, g_pcl, g_kps, params, head = _rot_head_case(61, b, p, k)
    cot = np.random.default_rng(62).normal(size=(b, 6)).astype(np.float32)

    def loss(prm, pf_, gp, gk):
        return jnp.sum(fused_rot_head_train(pf_, gp, gk, prm, p, True) * cot)

    v_ref, g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, (pf, g_pcl, g_kps)))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (pf, g_pcl, g_kps)]
    value = (train_ops.rot_head_train(*inputs, head, p, F32) * torch.from_numpy(cot)).sum()
    value.backward()
    assert abs(value.item() - float(v_ref)) < 1e-3
    for t, r in zip(inputs, g_ref[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)
    want = params_from_jax(_np_tree(g_ref[0]), head)
    for name, prm in head.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)


def test_wgmma_tn_plain_version():
    rng = np.random.default_rng(7)
    x, w0, w1 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
                 for s in ((64, 256), (256, 64), (256, 256)))
    outs = train_ops.wgmma_tn(x, w0, w1)               # CPU tensors: the plain version
    refs = (x.double() @ w1.double(), x.double() @ w0.double(), x.double()[:, :64] @ w0.double().T)
    for out, ref, shape in zip(outs, refs, ((64, 256), (64, 64), (64, 256))):
        assert out.shape == shape and out.dtype == F32
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5 * ref.abs().max().item())
