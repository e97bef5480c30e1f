"""What the bf16 kernels of K1 (`csrc/encoder_tail_wgmma.cuh`) and K2
(`csrc/encoder_stn_tail_wgmma.cuh`) rest on, held on the CPU:
  - the fold: the max of the bare f32 accumulator rounded once per (cloud,
    channel) (`fold_max_rounded`, for K2 followed by ReLU) is bit-equal to
    flax Dense's per-row rounding (then ReLU) followed by the max, on
    bf16-valued inputs from a numpy seed, with negative values, all-negative
    channels, exact ties and P = 1000, and over shapes drawn by hypothesis at
    small widths (128 -> 128 -> 128 for K1, 128 -> 128 for K2);
  - the plain versions of the kernels' order (`dense_relu_dense_max_folded_twin`,
    `dense_relu_max_folded_twin`) against the JAX package's
    `fused_dense_relu_dense_max` / `fused_dense_relu_max` in interpret mode,
    f32, 1e-5 (the tolerance of tests/test_encoder_epilogue.py);
  - the weight repack K1 streams (`pack_panels`) against an explicit formula
    of the 128-byte swizzle, and against the panel model of
    `csrc/wgmma_tile.cuh::stage_weight` in tests/test_torch_rot_head.py;
  - K2's persistent schedule (`stn_tail_schedule`): every (cloud, channel
    group) once, one group a block, no more blocks than SMs;
  - the reading of ptxas' report (`_build.ptxas_report`).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from catre_tpu.ops.pallas_encoder_epilogue import fused_dense_relu_dense_max, fused_dense_relu_max
from catre_tpu_torch.models.layers import dense
from catre_tpu_torch.ops import _build
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


# ---- K2: the STN tails, one product, ReLU after the rounding

def _k2_case(seed, n, p, kind="plain", cin=128, cout=128):
    """x, w, b with bf16 values (numpy seed) -> (x, w, b, accumulator (n, p,
    cout) f32 of the product). `kind`: "plain"; "all_negative" (the first 8
    channels below zero on every row, so that their ReLU'd max is exactly
    0); "ties" (every point there twice)."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, p, cin)))         # the STN's conv2 output is ReLU'd
    if kind == "ties":
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    w = rng.normal(size=(cout, cin)) / np.sqrt(cin)
    b = rng.normal(size=cout) * 0.5
    if kind == "all_negative":
        w[:8] = -np.abs(w[:8])
        b[:8] = -np.abs(b[:8])
    x, w, b = (torch.from_numpy(a.astype(np.float32)).to(BF16) for a in (x, w, b))
    return x, w, b, torch.nn.functional.linear(x.float(), w.float())


def _per_row_relu_then_max(acc, b):
    """flax Dense's rounding on every row (round, + b in bf16), ReLU, then the max."""
    return torch.relu(acc.to(BF16) + b).amax(dim=1).float()


@pytest.mark.parametrize("kind,n,p", [("plain", 3, 200), ("all_negative", 2, 130),
                                      ("ties", 2, 256), ("plain", 2, 1000)])
def test_relu_fold_is_bit_equal_to_per_row_rounding(kind, n, p):
    x, w, b, acc = _k2_case(40 + p, n, p, kind)
    assert (acc < 0).any()
    folded = enc_ops.dense_relu_max_folded_twin(x, w, b, BF16)
    assert folded.dtype == F32 and folded.shape == (n, 128)
    assert torch.equal(folded, torch.relu(enc_ops.fold_max_rounded(acc, b, BF16)))
    assert torch.equal(folded, _per_row_relu_then_max(acc, b))
    if kind == "all_negative":
        assert (acc[:, :, :8] < 0).all() and (folded[:, :8] == 0).all()
        assert not torch.signbit(folded[:, :8]).any()          # +0, as the per-row ReLU gives
    # the per-row plain version rounds the same bf16 sums: only the f32 order of the sums differs
    twin = enc_ops.dense_relu_max_twin(x, w, b, BF16)
    assert ((twin - folded).abs() <= 2.0 ** -7 * folded.abs().clamp(min=1.0)).all()


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 3), p=st.integers(1, 300), seed=st.integers(0, 2**16))
def test_relu_fold_is_bit_equal_to_per_row_rounding_over_shapes(n, p, seed):
    x, w, b, acc = _k2_case(seed, n, p)
    assert torch.equal(enc_ops.dense_relu_max_folded_twin(x, w, b, BF16),
                       _per_row_relu_then_max(acc, b))


@pytest.mark.parametrize("n,p", [(6, 64), (3, 40)])
def test_relu_folded_twin_matches_pallas(n, p):
    rng = np.random.default_rng(50 + n)
    x = rng.normal(size=(n, p, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 1024)) * 0.05).astype(np.float32)      # flax (in, out)
    b = (rng.normal(size=(1024,)) * 0.1).astype(np.float32)
    ref = fused_dense_relu_max(*map(jnp.asarray, (x, w, b)), block_clouds=4, interpret=True)
    out = enc_ops.dense_relu_max_folded_twin(_t(x), _t(w.T), _t(b), F32)
    assert out.dtype == F32 and out.shape == (n, 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("n", [1, 3, 8, 512])
def test_stn_tail_schedule_visits_every_item_once(n, chunks):
    n_sms, cout = 132, 1024
    grid, items = enc_ops.stn_tail_schedule(n, cout, n_sms, chunks)
    groups = cout // (128 * chunks)
    assert grid == len(items) and 1 <= grid <= n_sms and grid % groups == 0
    assert grid == groups * min(n_sms // groups, n)            # the largest such multiple
    flat = [item for block in items for item in block]
    assert sorted(flat) == [(c, g) for c in range(n) for g in range(groups)]
    for b, block in enumerate(items):
        assert block and {g for _, g in block} == {b % groups}   # one group a block, for life
        assert [c for c, _ in block] == sorted(c for c, _ in block)
    rounds = [len(block) for block in items]
    assert max(rounds) - min(rounds) <= 1                      # the last round is the only ragged one
    assert enc_ops.stn_tail_grid(n, cout, n_sms, chunks) == (grid, groups)


def test_stn_tail_schedule_takes_a_ragged_last_group():
    """640 channels in groups of two chunks: the last group holds one chunk."""
    grid, items = enc_ops.stn_tail_schedule(7, 640, 132, 2)
    assert grid == 3 * 7
    assert sorted(i for block in items for i in block) == [(c, g) for c in range(7)
                                                           for g in range(3)]
    with pytest.raises(ValueError):
        enc_ops.stn_tail_grid(4, 1024, 2, 1)                   # 8 groups, 2 SMs


def test_ptxas_report_reads_registers_stack_and_spills(monkeypatch):
    log = """ptxas info    : Compiling entry function '_ZN5catre4tail26dense_relu_dense_max_wgmmaILi8EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN5catre4tail26dense_relu_dense_max_wgmmaILi8EEEvPK
    128 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5catre3stn20dense_relu_max_wgmmaILi8ELi2EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN5catre3stn20dense_relu_max_wgmmaILi8ELi2EEEvPK
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 166 registers, 384 bytes cmem[0]
"""
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    assert _build.ptxas_report("encoder_epilogue", "dense_relu_max_wgmmaILi8E") == {
        "stack_frame": 8, "spill_stores": 12, "spill_loads": 16, "registers": 166}
    assert _build.ptxas_report("encoder_epilogue", "dense_relu_dense_max_wgmma") == {
        "stack_frame": 128, "spill_stores": 0, "spill_loads": 0, "registers": 168}
