"""What the wrapper of K9's bf16 build (`ops/encoder_chain.py`, kernels in
`csrc/encoder_chain_wgmma.cuh`) computes before it launches, held on the CPU
against plain constructions:
  - the weights each design takes (`bf16_weights`): the main column's W1, W2
    and W3 repacked as the 16 KB swizzled stages the producer streams, in
    stream order, against an explicit formula of the 128-byte swizzle; the
    STN columns' weights as they are, stn3d's 3-column W1 included (the
    kernel stages them itself);
  - the grid (`bf16_grid`): a block per cloud for the main design; K2's
    persistent grid for the STN design, every (cloud, channel group) once;
  - the widths and the x each design refuses (`check_k9_bf16`), on `meta`
    tensors, and x's 16-byte boundary on CPU tensors.
"""

import numpy as np
import pytest
import torch

from catre_tpu_torch.ops import encoder_chain as chain_ops
from catre_tpu_torch.ops import encoder_epilogue as enc_ops

BF16 = torch.bfloat16
MAIN = (64, 128, 512, 1024)
STN3D, STNKD = (3, 64, 128, 1024), (64, 64, 128, 1024)


def _weights(widths):
    """Distinct integer values per weight, (out, in) each."""
    return [torch.arange(cout * cin, dtype=torch.int64).reshape(cout, cin) + 10 ** 7 * i
            for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:]))]


def _stage_position(n, kk, k):
    """Element (n, kk) of an (N, k) weight in the stream of 16 KB stages: per
    128-row block, per 64-column panel, 128 rows of 128 bytes with the 16-byte
    chunk c of row r at position c ^ (r % 8); in 2-byte elements."""
    block, r = divmod(n, 128)
    panel, col = divmod(kk, 64)
    stage = block * (k // 64) + panel
    return stage * 8192 + r * 64 + ((col // 8) ^ (r & 7)) * 8 + col % 8


def test_main_column_weights_are_streamed_as_swizzled_stages():
    ws = _weights(MAIN)
    packed = chain_ops.bf16_weights("main", *ws)
    rng = np.random.default_rng(3)
    for w, p in zip(ws, packed):
        n_rows, k = w.shape
        flat = p.flatten()
        assert flat.numel() == w.numel() and sorted(flat.tolist()) == sorted(w.flatten().tolist())
        for n, kk in zip(rng.integers(0, n_rows, 1500), rng.integers(0, k, 1500)):
            assert flat[_stage_position(int(n), int(kk), k)] == w[n, kk]
    # W1 (128 x 64) is the one stage of layer 1; W2 2 stages a 128-channel chunk
    assert [p.numel() // 8192 for p in packed] == [1, 2 * 512 // 128, (512 // 64) * (1024 // 128)]


@pytest.mark.parametrize("widths", [STN3D, STNKD])
def test_stn_column_weights_are_passed_as_they_are(widths):
    ws = _weights(widths)
    for w, p in zip(ws, chain_ops.bf16_weights("stn", *[w.t().contiguous().t() for w in ws])):
        assert p.is_contiguous() and torch.equal(p, w)
    assert ws[0].shape == (64, widths[0])             # stn3d: 64 x 3, no padded copy


@pytest.mark.parametrize("n", [1, 7, 33, 512])
def test_stn_grid_is_k2s_and_takes_every_cloud_and_group_once(n):
    chunks, c3, n_sms = 2, 1024, 132
    grid = chain_ops.bf16_grid("stn", n, c3, n_sms, chunks)
    assert grid == enc_ops.stn_tail_grid(n, c3, n_sms, chunks)[0]
    groups = c3 // (128 * chunks)
    assert grid % groups == 0 and grid <= n_sms and grid <= n * groups
    # the kernel's walk: block b keeps group b % groups, clouds b // groups + k grid // groups
    seen = [(cloud, b % groups) for b in range(grid)
            for cloud in range(b // groups, n, grid // groups)]
    assert sorted(seen) == [(cloud, g) for cloud in range(n) for g in range(groups)]
    assert chain_ops.bf16_grid("main", n, c3, n_sms, chunks) == n


@pytest.mark.parametrize("widths,design", [(MAIN, "main"), ((64, 128, 128, 256), "main"),
                                           ((64, 128, 512, 4096), "main"), (STN3D, "stn"),
                                           (STNKD, "stn"), ((3, 64, 128, 384), "stn")])
def test_bf16_widths_taken(widths, design):
    x = torch.empty(2, 16, widths[0], device="meta", dtype=BF16)
    assert chain_ops.check_k9_bf16("chain3_max", x, *widths) == design


@pytest.mark.parametrize("widths", [(20, 192, 256, 384), (64, 128, 640, 1024),
                                    (64, 128, 512, 4224), (3, 128, 512, 1024),
                                    (128, 128, 512, 1024), (64, 64, 256, 1024),
                                    (128, 64, 128, 1024), (64, 192, 128, 1024)])
def test_bf16_widths_refused_name_the_limits(widths):
    x = torch.empty(2, 16, widths[0], device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="neither the main column's 64->128->"):
        chain_ops.check_k9_bf16("chain3_max", x, *widths)


def test_bf16_x_of_64_channels_starts_on_a_16_byte_boundary():
    buf = torch.zeros(2 * 16 * 64 + 1, dtype=BF16)
    x = buf[1:].view(2, 16, 64)
    assert x.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        chain_ops.check_k9_bf16("chain3_max", x, *MAIN)
    with pytest.raises(ValueError, match="16-byte boundary"):
        chain_ops.check_k9_bf16("chain3_max", x, *STNKD)
    assert chain_ops.check_k9_bf16("chain3_max", buf[:-1].view(2, 16, 64), *MAIN) == "main"
    x3 = torch.zeros(2 * 16 * 3 + 1, dtype=BF16)[1:].view(2, 16, 3)   # read as scalars
    assert chain_ops.check_k9_bf16("chain3_max", x3, *STN3D) == "stn"
