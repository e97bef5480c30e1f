"""What K1's bf16 kernel (`csrc/encoder_tail_wgmma.cuh`) rests on, held on the CPU:
  - the fold: the max of the bare f32 accumulator rounded once per (cloud,
    channel) (`fold_max_rounded`) is bit-equal to flax Dense's per-row
    rounding followed by the max, on bf16-valued inputs from a numpy seed,
    with negative values, all-negative channels, exact ties and P = 1000, and
    over shapes drawn by hypothesis at small widths (128 -> 128 -> 128);
  - the plain version of the kernel's order (`dense_relu_dense_max_folded_twin`)
    against the JAX package's `fused_dense_relu_dense_max` in interpret mode,
    f32, 1e-5 (the tolerance of tests/test_encoder_epilogue.py);
  - the weight repack the kernel streams (`pack_panels`) against an explicit
    formula of the 128-byte swizzle, and against the panel model of
    `csrc/wgmma_tile.cuh::stage_weight` in tests/test_torch_rot_head.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from catre_tpu.ops.pallas_encoder_epilogue import fused_dense_relu_dense_max
from catre_tpu_torch.models.layers import dense
from catre_tpu_torch.ops import encoder_epilogue as enc_ops

from test_torch_kernels import _t
from test_torch_rot_head import _stage_weight

BF16, F32 = torch.bfloat16, torch.float32


def _bf16_case(seed, n, p, widths=(128, 128, 128), kind="plain"):
    """x, w3, b3, w4, b4 with bf16 values (numpy seed) -> (accumulator (n, p,
    c4) f32 of the second product, b4). `kind`: "plain"; "all_negative"
    (the first 8 channels below zero on every row); "ties" (every point
    there twice)."""
    cin, chid, cout = widths
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p, cin))
    if kind == "ties":
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    w3 = rng.normal(size=(chid, cin)) / np.sqrt(cin)
    b3 = rng.normal(size=chid) * 0.1
    w4 = rng.normal(size=(cout, chid)) / np.sqrt(chid)
    b4 = rng.normal(size=cout) * 0.5
    if kind == "all_negative":
        w4[:8] = -np.abs(w4[:8])           # h >= 0 after the ReLU
    x, w3, b3, w4, b4 = (torch.from_numpy(a.astype(np.float32)).to(BF16)
                         for a in (x, w3, b3, w4, b4))
    h = dense(x, w3, b3, BF16, act=True)
    return torch.nn.functional.linear(h.float(), w4.float()), b4


def _per_row_then_max(acc, b4):
    """flax Dense's rounding on every row (round, + b in bf16), then the max."""
    return (acc.to(BF16) + b4).amax(dim=1).float()


@pytest.mark.parametrize("kind,n,p", [("plain", 3, 200), ("all_negative", 2, 130),
                                      ("ties", 2, 256), ("plain", 2, 1000)])
def test_fold_is_bit_equal_to_per_row_rounding(kind, n, p):
    acc, b4 = _bf16_case(20 + p, n, p, kind=kind)
    assert (acc < 0).any()
    if kind == "all_negative":
        assert (acc[:, :, :8] <= 0).all()
    folded = enc_ops.fold_max_rounded(acc, b4, BF16)
    assert folded.dtype == F32 and folded.shape == (n, 128)
    assert torch.equal(folded, _per_row_then_max(acc, b4))


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 3), p=st.integers(1, 300), seed=st.integers(0, 2**16))
def test_fold_is_bit_equal_to_per_row_rounding_over_shapes(n, p, seed):
    acc, b4 = _bf16_case(seed, n, p)
    assert torch.equal(enc_ops.fold_max_rounded(acc, b4, BF16), _per_row_then_max(acc, b4))


@pytest.mark.parametrize("n,p", [(4, 64), (3, 72)])
def test_folded_twin_matches_pallas(n, p):
    rng = np.random.default_rng(30 + n)
    x = rng.normal(size=(n, p, 128)).astype(np.float32)
    w3 = (rng.normal(size=(128, 512)) * 0.05).astype(np.float32)     # flax (in, out)
    b3 = (rng.normal(size=(512,)) * 0.1).astype(np.float32)
    w4 = (rng.normal(size=(512, 1024)) * 0.05).astype(np.float32)
    b4 = (rng.normal(size=(1024,)) * 0.1).astype(np.float32)
    ref = fused_dense_relu_dense_max(*map(jnp.asarray, (x, w3, b3, w4, b4)), interpret=True)
    out = enc_ops.dense_relu_dense_max_folded_twin(_t(x), _t(w3.T), _t(b3), _t(w4.T), _t(b4), F32)
    assert out.dtype == F32 and out.shape == (n, 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_rows,k", [(512, 128), (1024, 512), (384, 64)])
def test_pack_panels_is_the_swizzled_stage_order(n_rows, k):
    w = torch.arange(n_rows * k, dtype=torch.int64).reshape(n_rows, k)
    packed = enc_ops.pack_panels(w).flatten()
    assert sorted(packed.tolist()) == list(range(n_rows * k))          # a permutation
    rng = np.random.default_rng(1)
    for n, kk in zip(rng.integers(0, n_rows, 2000), rng.integers(0, k, 2000)):
        block, r = divmod(int(n), 128)
        panel, col = divmod(int(kk), 64)
        stage = block * (k // 64) + panel                       # 16 KB stages, streamed in order
        pos = stage * 8192 + r * 64 + ((col // 8) ^ (r & 7)) * 8 + col % 8   # 2-byte elements
        assert packed[pos] == w[n, kk]
    # each stage is the panel that `stage_weight` writes for those 128 rows
    for block in range(n_rows // 128):
        staged = _stage_weight(w[128 * block:128 * block + 128].numpy())
        got = packed[block * 128 * k:(block + 1) * 128 * k].numpy()
        assert (got == staged).all()


def test_pack_panels_refuses_ragged_blocks():
    with pytest.raises(ValueError):
        enc_ops.pack_panels(torch.zeros(200, 128, dtype=BF16))
    with pytest.raises(ValueError):
        enc_ops.pack_panels(torch.zeros(256, 96, dtype=BF16))
