"""CUDA kernels K1-K9 vs their plain PyTorch versions on the card (the bf16
builds of K1 and K2 also vs the plain versions of their own order, relaunched
bit-equal; the K6 and K5 forwards' idx bit-equal to the plain version's on
exact-integer operands, with ties at -0 / +0, relaunched bit-equal, and what
their bf16 builds refuse; the bf16 K6 and K5 backwards also vs their
critical-row plain versions, with dx in bf16 and zero off the rows a live
channel points at, relaunched bit-equal, their refused widths and their
scratch; the bf16 K9 for its three columns at point counts its tile does not
divide, relaunched bit-equal, and the x and widths it refuses), the inference
kernels' refusal of a differentiable call, a train step's launch counts,
and the ball-crop sampler and the loader's group samplers on the card
against the same functions on the CPU (equal indices and n_inside,
bit-equal points, one priority field drawn on the CPU for both).

Every test here is marked `cuda` and skips without a card. The file imports
no JAX, so it runs on a machine without it; `tests/conftest.py` sets up JAX,
so there run it with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Tolerances are relative to max(1, max|twin|): f32 1e-4 (only the summation
order differs), bf16 3e-2 (a few bf16 ulps where a summation-order
difference flips a rounding).
"""

import pytest
import torch

from catre_tpu_torch.models.heads import ConvOutPerRotHead
from catre_tpu_torch.models.layers import Dense, dense
from catre_tpu_torch.ops import encoder_chain as chain_ops
from catre_tpu_torch.ops import encoder_epilogue as enc_ops
from catre_tpu_torch.ops import encoder_epilogue_train as tail_ops
from catre_tpu_torch.ops import rot_head as rot_ops
from catre_tpu_torch.ops import rot_head_multi as multi_ops
from catre_tpu_torch.ops import rot_head_train as train_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _assert_close(out, ref, cdt):
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= TOL[cdt] * max(1.0, ref.abs().max().item()), err


def _assert_nearer(out, own, other):
    """The tolerances above cannot tell two roundings of one function apart:
    the kernel must lie well nearer its own plain version than a sibling
    that rounds elsewhere does (mean absolute difference)."""
    torch.cuda.synchronize()
    err, gap = (out - own).abs().mean().item(), (own - other).abs().mean().item()
    assert err <= 0.25 * gap, (err, gap)


def _dense(gen, cin, cout, dev):
    layer = Dense(cin, cout, gen)
    return layer.weight.detach().to(dev), layer.bias.detach().to(dev)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("n,p", [(16, 1024), (5, 100)])
def test_dense_relu_max_kernel(dev, cdt, n, p):
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, p, 128, generator=gen).to(dev, cdt)
    w, b = _dense(gen, 128, 1024, dev)
    before = enc_ops.LAUNCHES["dense_relu_max"]
    out = enc_ops.dense_relu_max(x, w, b, cdt)
    assert enc_ops.LAUNCHES["dense_relu_max"] == before + 1
    _assert_close(out, enc_ops.dense_relu_max_twin(x, w, b, cdt), cdt)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("n,p", [(16, 1024), (5, 100)])
def test_dense_relu_dense_max_kernel(dev, cdt, n, p):
    gen = torch.Generator().manual_seed(100 + n)
    x = torch.relu(torch.randn(n, p, 128, generator=gen)).to(dev, cdt)
    w3, b3 = _dense(gen, 128, 512, dev)
    w4, b4 = _dense(gen, 512, 1024, dev)
    out = enc_ops.dense_relu_dense_max(x, w3, b3, w4, b4, cdt)
    _assert_close(out, enc_ops.dense_relu_dense_max_twin(x, w3, b3, w4, b4, cdt), cdt)


def _k1_case(seed, n, p, dev, cdt):
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(n, p, 128, generator=gen)).to(dev, cdt)
    return x, [*_dense(gen, 128, 512, dev), *_dense(gen, 512, 1024, dev)]


@pytest.mark.parametrize("p", [1024, 1000])
def test_dense_relu_dense_max_bf16_kernel_vs_both_plain_versions(dev, p):
    """The wgmma K1 (max on the bare accumulator) against the plain version
    that rounds every row and the one in the kernel's own order, at a point
    count its 128-point tile divides and at one it does not."""
    x, ws = _k1_case(200 + p, 8, p, dev, torch.bfloat16)
    before = enc_ops.LAUNCHES["dense_relu_dense_max"]
    out = enc_ops.dense_relu_dense_max(x, *ws, torch.bfloat16)
    assert enc_ops.LAUNCHES["dense_relu_dense_max"] == before + 1
    assert out.shape == (8, 1024) and torch.isfinite(out).all()
    _assert_close(out, enc_ops.dense_relu_dense_max_twin(x, *ws, torch.bfloat16), torch.bfloat16)
    _assert_close(out, enc_ops.dense_relu_dense_max_folded_twin(x, *ws, torch.bfloat16),
                  torch.bfloat16)


def test_dense_relu_dense_max_bf16_launches_are_bit_equal(dev):
    """The running maxima are folded by atomics in any order: the max is exact,
    so four launches give the same bits."""
    x, ws = _k1_case(7, 12, 1000, dev, torch.bfloat16)
    outs = [enc_ops.dense_relu_dense_max(x, *ws, torch.bfloat16) for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def _k2_case(seed, n, p, dev, cdt, cin=128, cout=1024):
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(n, p, cin, generator=gen)).to(dev, cdt)
    return x, list(_dense(gen, cin, cout, dev))


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("p", [1024, 1000, 40])
def test_dense_relu_max_bf16_kernel_vs_both_plain_versions(dev, n, p):
    """The wgmma K2 (persistent blocks, max on the bare accumulator) against
    the plain version that rounds every row and the one in the kernel's own
    order: fewer work items than SMs, a tile its 128 points do not fill, a
    slot less than a warp's 16 rows full."""
    x, ws = _k2_case(300 + n + p, n, p, dev, torch.bfloat16)
    before = enc_ops.LAUNCHES["dense_relu_max"]
    out = enc_ops.dense_relu_max(x, *ws, torch.bfloat16)
    assert enc_ops.LAUNCHES["dense_relu_max"] == before + 1
    assert out.shape == (n, 1024) and torch.isfinite(out).all()
    _assert_close(out, enc_ops.dense_relu_max_twin(x, *ws, torch.bfloat16), torch.bfloat16)
    _assert_close(out, enc_ops.dense_relu_max_folded_twin(x, *ws, torch.bfloat16), torch.bfloat16)


def test_dense_relu_max_bf16_launches_are_bit_equal(dev):
    """The running maxima are folded by atomics in any order and a slot given
    back too early would show only sometimes: four launches, the same bits."""
    x, ws = _k2_case(8, 300, 1000, dev, torch.bfloat16)
    outs = [enc_ops.dense_relu_max(x, *ws, torch.bfloat16) for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("cdt", DTYPES)
def test_dense_relu_max_train_forward_is_bit_equal_to_k2(dev, cdt):
    """The K5 forward (per-row rounding, in bf16 K2's `wgmma` kernel with the
    keyed fold) and K2 (the bare accumulator's max in bf16) give the same
    bits."""
    x, ws = _k2_case(9, 8, 1000, dev, cdt)
    with torch.no_grad():
        out, _ = tail_ops.dense_relu_max_fwd(x, *ws, cdt)
        assert torch.equal(out, enc_ops.dense_relu_max(x, *ws, cdt))


def test_dense_relu_max_bf16_refuses_what_it_does_not_take(dev):
    x, ws = _k2_case(10, 2, 64, dev, torch.bfloat16, cin=192)
    with pytest.raises(ValueError, match="64 or 128"):
        enc_ops.dense_relu_max(x, *ws, torch.bfloat16)
    enc_ops.dense_relu_max(x.float(), *ws, torch.float32)          # the f32 build takes it
    x, ws = _k2_case(11, 2, 64, dev, torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        enc_ops.dense_relu_max(x.flatten()[1:1 + 2 * 63 * 128].view(2, 63, 128), *ws,
                               torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        enc_ops.dense_relu_max(x.requires_grad_(), *ws, torch.bfloat16)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,p,k", [(8, 1024, 1024), (3, 96, 40), (5, 150, 43), (2, 20, 9)])
def test_rot_head_kernel(dev, cdt, b, p, k):
    gen = torch.Generator().manual_seed(b)
    head = ConvOutPerRotHead(gen, num_points=p + k)
    with torch.no_grad():
        for prm in head.parameters():
            prm.mul_(50.0)   # signal well above the 1e-3 init
    head.to(dev)
    pf = (torch.randn(b, p + k, 64, generator=gen) * 0.5).to(dev, cdt)
    g_pcl = (torch.randn(b, 1024, generator=gen) * 0.5).to(dev)
    g_kps = (torch.randn(b, 1024, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, cdt)
        gterm = torch.stack([g_pcl, g_kps], dim=1) @ pack.w_g.T
        out = rot_ops.rot_head(pf, gterm, pack, p)
        _assert_close(out, rot_ops.rot_head_twin(pf, gterm, pack, p), cdt)


def _chain_inputs(kind, dev):
    """Canned operands of the two chained products: `pattern` gives every
    element of x and every row of w0 a value of its own that bf16 holds
    exactly (a misplaced fragment shows as a wrong integer); `random` is
    seeded noise."""
    if kind == "pattern":
        x = (torch.arange(64)[:, None] - 32 + (torch.arange(64)[None, :] % 7) * 0.25).float()
        w0 = torch.zeros(256, 64)
        w0[torch.arange(256), torch.arange(256) % 64] = 1.0 + (torch.arange(256) // 64).float()
        w1 = torch.zeros(256, 256)
        w1[torch.arange(256), (torch.arange(256) * 5 + 3) % 256] = 1.0
    else:
        gen = torch.Generator().manual_seed(7)
        x, w0, w1 = (torch.randn(*s, generator=gen) for s in ((64, 64), (256, 64), (256, 256)))
    return [t.to(dev, torch.bfloat16) for t in (x, w0, w1)]


@pytest.mark.parametrize("kind", ["pattern", "random"])
def test_wgmma_chain_kernel(dev, kind):
    """The accumulator of one wgmma is the A fragment of the next (n-tiles
    2 s and 2 s + 1 are k-step s), and the staged weight panels and their
    descriptors address what they should. f32 accumulation of exact bf16
    products: only the summation order differs from the plain version, and a
    sum that rounds the other way before the chain rounds it to bf16 moves
    one operand of the second product by a bf16 ulp."""
    x, w0, w1 = _chain_inputs(kind, dev)
    out0, out1 = rot_ops.wgmma_chain(x, w0, w1)
    ref0, ref1 = rot_ops.wgmma_chain_plain(x, w0, w1)
    torch.cuda.synchronize()
    if kind == "pattern":     # one product per output: exact
        assert torch.equal(out0, ref0) and torch.equal(out1, ref1)
    else:
        assert (out0 - ref0).abs().max().item() <= 1e-5 * ref0.abs().max().item()
        assert (out1 - ref1).abs().max().item() <= 1e-3 * ref1.abs().max().item()


@pytest.mark.parametrize("b,p,k", [(8, 1024, 1024), (3, 96, 40), (5, 150, 43), (2, 20, 9)])
def test_rot_head_two_launches_are_bit_equal(dev, b, p, k):
    """bf16 K3: sums in a fixed order, no atomics; also at point counts that
    the 64-point tile does not divide and with fewer points than one tile."""
    gen = torch.Generator().manual_seed(40 + b)
    head = _scaled_head(gen, p + k, dev)
    pf = (torch.randn(b, p + k, 64, generator=gen) * 0.5).to(dev, torch.bfloat16)
    g2 = (torch.randn(b, 2, 1024, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, torch.bfloat16)
        gterm = (g2 @ pack.w_g.T).contiguous()
        outs = [rot_ops.rot_head(pf, gterm, pack, p) for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
        _assert_close(outs[0], rot_ops.rot_head_twin(pf, gterm, pack, p), torch.bfloat16)


def test_rot_head_ignores_what_lies_past_the_last_point(dev):
    """bf16 K3 at a ragged P: the same object inside a longer batch row
    (other points after it in device memory) gives the same bits as alone."""
    gen = torch.Generator().manual_seed(50)
    p, k = 100, 37
    head = _scaled_head(gen, p + k, dev)
    pf = (torch.randn(4, p + k, 64, generator=gen) * 0.5).to(dev, torch.bfloat16)
    g2 = (torch.randn(4, 2, 1024, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, torch.bfloat16)
        gterm = (g2 @ pack.w_g.T).contiguous()
        whole = rot_ops.rot_head(pf, gterm, pack, p)
        alone = torch.cat([rot_ops.rot_head(pf[i:i + 1].clone(), gterm[i:i + 1].clone(), pack, p)
                           for i in range(4)])
        torch.cuda.synchronize()
        assert torch.equal(whole, alone)


def test_wrappers_raise_on_bad_input(dev):
    x = torch.randn(4, 64, 128, device=dev)
    w = torch.randn(1024, 128, device=dev)
    b = torch.randn(1024, device=dev)
    with pytest.raises(ValueError):
        enc_ops.dense_relu_max(x.transpose(0, 1), w, b, torch.float32)   # not contiguous
    with pytest.raises(ValueError):
        enc_ops.dense_relu_max(x, w, b, torch.bfloat16)                  # x not in cdt
    with pytest.raises(ValueError):
        enc_ops.dense_relu_max(x, w[:1000], b[:1000], torch.float32)     # width
    w3, w4 = torch.randn(640, 128, device=dev), torch.randn(1024, 640, device=dev)
    b3 = torch.randn(640, device=dev)
    enc_ops.dense_relu_dense_max(x, w3, b3, w4, b, torch.float32)      # f32 takes it
    with pytest.raises(ValueError):                                      # the bf16 h tile does not
        enc_ops.dense_relu_dense_max(x.bfloat16(), w3, b3, w4, b, torch.bfloat16)


def _scaled_head(gen, n_points, dev):
    head = ConvOutPerRotHead(gen, num_points=n_points)
    with torch.no_grad():
        for prm in head.parameters():
            prm.mul_(50.0)   # signal well above the 1e-3 init
    return head.to(dev)


@pytest.mark.parametrize("cdt", DTYPES)
def _bwd_inputs(seed, b, p, k, dev, cdt):
    """-> (pf, gterm, pack, d_out) of `rot_head_bwd` for b objects of p + k points."""
    gen = torch.Generator().manual_seed(seed)
    head = _scaled_head(gen, p + k, dev)
    pf = (torch.randn(b, p + k, 64, generator=gen) * 0.5).to(dev, cdt)
    g2 = (torch.randn(b, 2, 1024, generator=gen) * 0.5).to(dev)
    d_out = torch.randn(b, 6, generator=gen).to(dev)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, cdt, weight_dtype=torch.float32)
        return pf, (g2 @ pack.w_g.T).contiguous(), pack, d_out


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,p,k", [(4, 1024, 1024), (3, 96, 40), (5, 150, 43), (2, 20, 9),
                                   (2, 1000, 999)])
def test_rot_head_bwd_kernel(dev, cdt, b, p, k):
    """Also at point counts that the bf16 kernel's 64-point tile does not
    divide, with the cloud / keypoint boundary inside a tile, and with fewer
    points than one tile."""
    pf, gterm, pack, d_out = _bwd_inputs(10 + b, b, p, k, dev, cdt)
    with torch.no_grad():
        before = train_ops.LAUNCHES["rot_head_bwd"]
        out = train_ops.rot_head_bwd(pf, gterm, pack, p, d_out)
        assert train_ops.LAUNCHES["rot_head_bwd"] == before + 1
        ref = train_ops.rot_head_bwd_twin(pf, gterm, pack, p, d_out)
    for name in train_ops.GRAD_NAMES:
        assert out[name].shape == ref[name].shape and torch.isfinite(out[name]).all(), name
        _assert_close(out[name], ref[name], cdt)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,p,k", [(6, 1024, 1024), (3, 150, 43)])
def test_rot_head_bwd_launches_are_bit_equal(dev, cdt, b, p, k):
    """Sums in a fixed order, no atomics: every gradient tensor, three launches."""
    pf, gterm, pack, d_out = _bwd_inputs(60 + b, b, p, k, dev, cdt)
    with torch.no_grad():
        outs = [train_ops.rot_head_bwd(pf, gterm, pack, p, d_out) for _ in range(3)]
    torch.cuda.synchronize()
    for name in train_ops.GRAD_NAMES:
        assert torch.equal(outs[0][name], outs[1][name]), name
        assert torch.equal(outs[0][name], outs[2][name]), name


def test_rot_head_bwd_ignores_what_lies_past_the_last_point(dev):
    """bf16 K4 at a ragged P: an object inside a batch (other objects' points
    behind its own in device memory) gets the same d_pf and d_gterm bits as
    alone, and the parameter gradients are the sums over the objects."""
    p, k = 100, 37
    pf, gterm, pack, d_out = _bwd_inputs(70, 4, p, k, dev, torch.bfloat16)
    with torch.no_grad():
        whole = train_ops.rot_head_bwd(pf, gterm, pack, p, d_out)
        alone = [train_ops.rot_head_bwd(pf[i:i + 1].clone(), gterm[i:i + 1].clone(), pack, p,
                                        d_out[i:i + 1].clone()) for i in range(4)]
    torch.cuda.synchronize()
    for name in ("pf", "gterm"):
        assert torch.equal(whole[name], torch.cat([a[name] for a in alone])), name
    for name in ("b0", "gn1s", "pw", "neck"):      # summed over objects in object order
        total = alone[0][name].clone()
        for a in alone[1:]:
            total += a[name]
        assert torch.equal(whole[name], total), name


@pytest.mark.parametrize("kind", ["pattern", "random"])
def test_wgmma_tn_kernel(dev, kind):
    """A weight staged once for a @ W^T and read transposed for a @ W (the
    MN-major descriptor under the 128-byte swizzle), whole and accumulated
    over quarters of its rows, and the forward product by 64-column quarters.
    `pattern`: one non-zero per weight row and column, values bf16 holds
    exactly, so every output is one product and a misread panel shows as a
    wrong integer."""
    if kind == "pattern":
        x = (torch.arange(64)[:, None] - 32 + (torch.arange(256)[None, :] % 7) * 0.25).float()
        w0 = torch.zeros(256, 64)
        w0[torch.arange(64) * 4 + torch.arange(64) % 4, (torch.arange(64) * 5 + 3) % 64] = 2.0
        w1 = torch.zeros(256, 256)
        w1[torch.arange(256), (torch.arange(256) * 5 + 3) % 256] = 1.0 + (torch.arange(256) % 3)
    else:
        gen = torch.Generator().manual_seed(8)
        x, w0, w1 = (torch.randn(*s, generator=gen) for s in ((64, 256), (256, 64), (256, 256)))
    x, w0, w1 = (t.to(dev, torch.bfloat16) for t in (x, w0, w1))
    outs, refs = train_ops.wgmma_tn(x, w0, w1), train_ops.wgmma_tn_plain(x, w0, w1)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        if kind == "pattern":
            assert torch.equal(out, ref)
        else:
            assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    with pytest.raises(ValueError):
        train_ops.wgmma_tn(x[:, :64].contiguous(), w0, w1)


def test_inference_kernels_refuse_a_differentiable_call(dev):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, 128, generator=gen).to(dev)
    w, b = _dense(gen, 128, 1024, dev)
    w3, b3 = _dense(gen, 128, 512, dev)
    w4, b4 = _dense(gen, 512, 1024, dev)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        enc_ops.dense_relu_max(x, w, b, torch.float32)
    with pytest.raises(RuntimeError, match="requires grad"):
        enc_ops.dense_relu_dense_max(x.bfloat16().requires_grad_(), w3, b3, w4, b4,
                                     torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        enc_ops.dense_relu_dense_max(x.requires_grad_(), w3, b3, w4, b4, torch.float32)
    head = _scaled_head(gen, 128, dev)
    pack = rot_ops.pack_rot_head(head, torch.float32)          # differentiable in the head
    pf = torch.randn(2, 128, 64, generator=gen).to(dev)
    gterm = torch.randn(2, 2, 512, generator=gen).to(dev)
    with pytest.raises(RuntimeError, match="rot_head_train"):
        rot_ops.rot_head(pf, gterm, pack, 64)
    with torch.no_grad():
        rot_ops.rot_head(pf, gterm, rot_ops.pack_rot_head(head, torch.float32), 64)


def _tail_case(kind, gen, n, p, dev, cdt, ties, widths=(128, 512, 1024)):
    """-> (x in cdt, [f32 weights and biases], d_out); with `ties` every point
    is there twice and, for K5, 16 channels are negative on every row."""
    cin, chid, cout = widths
    x = torch.relu(torch.randn(n, p, cin, generator=gen))
    if ties:
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    if kind == "K5":
        ws = list(_dense(gen, cin, cout, dev))
        if ties:
            ws[1][:16] = -50.0
    else:
        ws = [*_dense(gen, cin, chid, dev), *_dense(gen, chid, cout, dev)]
    return x.to(dev, cdt), ws, torch.randn(n, cout, generator=gen).to(dev)


TAIL_OPS = {
    "K5": (tail_ops.dense_relu_max_fwd, tail_ops.dense_relu_max_fwd_plain,
           tail_ops.dense_relu_max_bwd, tail_ops.dense_relu_max_bwd_plain,
           enc_ops.dense_relu_max, "dense_relu_max_train"),
    "K6": (tail_ops.dense_relu_dense_max_fwd, tail_ops.dense_relu_dense_max_fwd_plain,
           tail_ops.dense_relu_dense_max_bwd, tail_ops.dense_relu_dense_max_bwd_plain,
           enc_ops.dense_relu_dense_max, "dense_relu_dense_max_train"),
}


# the last case: widths other than the flagship's (cout not a power of two,
# cin below one 128-column tile, chid not a multiple of 256)
@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("n,p,ties,widths", [
    (16, 1024, False, (128, 512, 1024)), (5, 100, False, (128, 512, 1024)),
    (6, 200, True, (128, 512, 1024)), (20, 150, False, (64, 384, 640))])
@pytest.mark.parametrize("kind", ["K5", "K6"])
def test_train_tail_kernels(dev, kind, cdt, n, p, ties, widths):
    fwd, fwd_plain, bwd, bwd_plain, infer, counter = TAIL_OPS[kind]
    x, ws, d_out = _tail_case(kind, torch.Generator().manual_seed(n), n, p, dev, cdt, ties,
                              widths)
    before = dict(tail_ops.LAUNCHES)
    with torch.no_grad():
        out, idx = fwd(x, *ws, cdt)
        grads = bwd(x, *ws, idx, d_out, cdt)
        assert tail_ops.LAUNCHES[counter + "_fwd"] == before[counter + "_fwd"] + 1
        assert tail_ops.LAUNCHES[counter + "_bwd"] == before[counter + "_bwd"] + 1
        out_p, idx_p = fwd_plain(x, *ws, cdt)
        assert torch.equal(out, infer(x, *ws, cdt))          # bit-equal to K2 / K1
        _assert_close(out, out_p, cdt)
        assert idx.dtype == torch.int32 and idx.min() >= 0 and idx.max() < p
        if cdt == torch.float32 and not ties:
            # rows may differ only where two rows are within an f32 rounding of each other
            assert (idx != idx_p).float().mean().item() < 1e-4
        if ties:
            assert idx.max() < p // 2                         # the lowest of two equal rows
            if kind == "K5":
                assert (idx[:, :16] == 0).all()
        again = bwd(x, *ws, idx, d_out, cdt)                  # no float atomics
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        assert grads[0].dtype == cdt                          # dx in x's dtype, no cast after
        for g, ref in zip(grads, bwd_plain(x, *ws, idx, d_out, cdt)):
            assert g.shape == ref.shape and (g is grads[0] or g.dtype == torch.float32)
            _assert_close(g.float(), ref, cdt)
        if ties:
            assert grads[0][:, p // 2:].abs().max() == 0      # dx only on the lowest rows


def test_train_tail_wrappers_raise_on_bad_input(dev):
    x, ws, d_out = _tail_case("K5", torch.Generator().manual_seed(0), 4, 64, dev, torch.float32,
                              False)
    w, b = ws
    idx = torch.zeros(4, 1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_fwd(x, w, b, torch.bfloat16)                 # x not in cdt
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_fwd(x, w[:1000], b[:1000], torch.float32)    # width
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_fwd(x.transpose(0, 1), w, b, torch.float32)  # not contiguous
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_bwd(x, w, b, idx.long(), d_out, torch.float32)   # idx not int32
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_bwd(x, w, b, idx.cpu(), d_out, torch.float32)    # idx on the CPU
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_bwd(x, w.bfloat16(), b, idx, d_out, torch.float32)   # weight dtype
    with pytest.raises(ValueError):
        tail_ops.dense_relu_max_bwd(x, w, b, idx, d_out[:, :512], torch.float32)     # d_out shape
    with pytest.raises(RuntimeError, match="requires grad"):                         # bare call
        tail_ops.dense_relu_max_fwd(x, w.clone().requires_grad_(), b, torch.float32)
    out = tail_ops.dense_relu_max_train(x, w.clone().requires_grad_(), b, torch.float32)
    assert out.grad_fn is not None


def _k6_bwd_case(dev, n, p, seed=0):
    """The bf16 K6 backward's inputs at the train step's widths: x, weights,
    idx from the K6 forward, d_out with a sixth of the channels dead."""
    gen = torch.Generator().manual_seed(seed)
    x, ws, d_out = _tail_case("K6", gen, n, p, dev, torch.bfloat16, False)
    d_out[:, ::6] = 0.0
    with torch.no_grad():
        _, idx = tail_ops.dense_relu_dense_max_fwd(x, *ws, torch.bfloat16)
    return x, ws, idx, d_out


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("p", [1024, 1000, 40, 2500])      # 2500: the routing pass's three row tiles
def test_k6_bwd_bf16_vs_both_plain_versions(dev, n, p):
    x, ws, idx, d_out = _k6_bwd_case(dev, n, p, seed=n)
    bf = torch.bfloat16
    with torch.no_grad():
        grads = tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, bf)
        for plain in (tail_ops.dense_relu_dense_max_bwd_plain,
                      tail_ops.dense_relu_dense_max_bwd_critical_plain):
            for g, ref in zip(grads, plain(x, *ws, idx, d_out, bf)):
                assert g.shape == ref.shape and g.dtype == (bf if g is grads[0] else torch.float32)
                _assert_close(g.float(), ref, bf)


def test_k6_bwd_bf16_six_launches_are_bit_equal(dev):
    x, ws, idx, d_out = _k6_bwd_case(dev, 40, 1024)
    with torch.no_grad():
        first = tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, torch.bfloat16)
        for _ in range(5):
            again = tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, torch.bfloat16)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k6_bwd_bf16_dx_is_zero_on_rows_no_channel_points_at(dev):
    n, p = 8, 1000
    x, ws, idx, d_out = _k6_bwd_case(dev, n, p)
    with torch.no_grad():
        dx = tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, torch.bfloat16)[0]
    hit = torch.zeros(n, p, dtype=torch.bool, device=dev)
    live = d_out.bfloat16() != 0
    hit[torch.arange(n, device=dev)[:, None].expand_as(idx)[live], idx.long()[live]] = True
    assert dx[~hit].abs().max() == 0 and dx[hit].abs().max() > 0


def test_k6_bwd_bf16_refuses_widths_it_does_not_take(dev):
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    for cin, chid, cout in [(192, 512, 1024), (128, 1024, 1024)]:   # cin; W3 past shared memory
        x, ws, d_out = _tail_case("K6", gen, 2, 64, dev, bf, False, (cin, chid, cout))
        idx = torch.zeros(2, cout, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="bf16"):
            tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, bf)
    x, ws, idx, d_out = _k6_bwd_case(dev, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tail_ops.dense_relu_dense_max_bwd(_misaligned(x), *ws, idx, d_out, bf)


def _misaligned(x):
    """x's values in a tensor that starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def test_k6_bwd_bf16_allocates_no_scratch_of_n_p_chid(dev):
    n, p = 256, 1024
    x, ws, idx, d_out = _k6_bwd_case(dev, n, p)
    chid = ws[0].shape[0]
    with torch.no_grad():
        tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, torch.bfloat16)   # build, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs = tail_ops.dense_relu_dense_max_bwd(x, *ws, idx, d_out, torch.bfloat16)
        torch.cuda.synchronize()
    beyond = torch.cuda.max_memory_allocated() - base - sum(o.numel() * o.element_size() for o in outs)
    assert beyond < 0.1 * n * p * chid * 2, beyond


def _k5_bwd_case(dev, n, p, seed=0, widths=(128, 1024)):
    """The bf16 K5 backward's inputs: x, weights with every fourth channel's
    bias at -50 (its gate closed on every row, idx 0), idx from the K5
    forward, d_out with a sixth of the channels zero."""
    cin, cout = widths
    x, ws, d_out = _tail_case("K5", torch.Generator().manual_seed(seed), n, p, dev,
                              torch.bfloat16, False, (cin, 0, cout))
    ws[1][::4] = -50.0
    d_out[:, ::6] = 0.0
    with torch.no_grad():
        _, idx = tail_ops.dense_relu_max_fwd(x, *ws, torch.bfloat16)
    return x, ws, idx, d_out


def _k5_hit_rows(x, ws, idx, d_out):
    """(N, P) rows that a live channel points at, counting as live every
    channel whose gate is within a rounding of flipping (the kernel's f32 dot
    sums in another order than the plain one)."""
    n, p, cin = x.shape
    wc = ws[0].bfloat16().float()
    rows = torch.gather(x.float(), 1, idx.long()[:, :, None].expand(-1, -1, cin))
    pre = (rows * wc).sum(dim=2) + ws[1]
    near = pre.abs() <= 1e-4 * max(1.0, pre.abs().max().item())
    live = ((pre > 0) | near) & (d_out.bfloat16() != 0)
    hit = torch.zeros(n, p, dtype=torch.bool, device=x.device)
    hit[torch.arange(n, device=x.device)[:, None].expand_as(idx)[live], idx.long()[live]] = True
    return hit


@pytest.mark.parametrize("n,p,widths", [(1, 1024, (128, 1024)), (3, 1000, (128, 1024)),
                                        (8, 40, (128, 1024)), (8, 1024, (128, 1024)),
                                        (5, 300, (64, 640)), (3, 2500, (128, 1024))])
def test_k5_bwd_bf16_vs_both_plain_versions(dev, n, p, widths):
    x, ws, idx, d_out = _k5_bwd_case(dev, n, p, seed=n + p, widths=widths)
    bf = torch.bfloat16
    with torch.no_grad():
        before = tail_ops.LAUNCHES["dense_relu_max_train_bwd"]
        grads = tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, bf)
        assert tail_ops.LAUNCHES["dense_relu_max_train_bwd"] == before + 1
        assert [g.dtype for g in grads] == [bf, torch.float32, torch.float32]
        for plain in (tail_ops.dense_relu_max_bwd_plain, tail_ops.dense_relu_max_bwd_critical_plain):
            for g, ref in zip(grads, plain(x, *ws, idx, d_out, bf)):
                assert g.shape == ref.shape
                _assert_close(g.float(), ref.float(), bf)


def test_k5_bwd_bf16_six_launches_are_bit_equal(dev):
    x, ws, idx, d_out = _k5_bwd_case(dev, 40, 1024)
    with torch.no_grad():
        first = tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, torch.bfloat16)
        for _ in range(5):
            again = tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, torch.bfloat16)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k5_bwd_bf16_dx_is_zero_on_rows_no_live_channel_points_at(dev):
    n, p = 8, 1000
    x, ws, idx, d_out = _k5_bwd_case(dev, n, p)
    with torch.no_grad():
        dx = tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, torch.bfloat16)[0]
    hit = _k5_hit_rows(x, ws, idx, d_out)
    assert dx.dtype == torch.bfloat16
    assert dx[~hit].abs().max() == 0 and dx[hit].abs().max() > 0
    assert (idx[:, ::4] == 0).all()        # the closed gates point at row 0 and add nothing there


def test_k5_bwd_bf16_refuses_what_it_does_not_take(dev):
    bf = torch.bfloat16
    x, ws, d_out = _tail_case("K5", torch.Generator().manual_seed(0), 2, 64, dev, bf, False,
                              (192, 0, 1024))
    idx = torch.zeros(2, 1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="64 or 128"):
        tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, bf)
    x, ws, d_out = _tail_case("K5", torch.Generator().manual_seed(1), 2, 64, dev, bf, False,
                              (128, 0, 2048))
    idx = torch.zeros(2, 2048, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, bf)
    dx = tail_ops.dense_relu_max_bwd(x.float(), *ws, idx, d_out, torch.float32)[0]   # f32 takes it
    assert dx.dtype == torch.float32
    x, ws, idx, d_out = _k5_bwd_case(dev, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tail_ops.dense_relu_max_bwd(_misaligned(x), *ws, idx, d_out, bf)


def test_k5_bwd_bf16_allocates_no_scratch_of_n_p_cin(dev):
    n, p = 1024, 1024      # the train step's clouds: the dW partials do not grow with N
    x, ws, idx, d_out = _k5_bwd_case(dev, n, p)
    with torch.no_grad():
        tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, torch.bfloat16)   # build, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs = tail_ops.dense_relu_max_bwd(x, *ws, idx, d_out, torch.bfloat16)
        torch.cuda.synchronize()
    beyond = torch.cuda.max_memory_allocated() - base - sum(o.numel() * o.element_size() for o in outs)
    assert beyond < 0.1 * n * p * x.shape[2] * 2, beyond


def _k6_int_case(seed, n, p, dev, cdt, widths=(128, 512, 1024), twice=False):
    """Exact-integer K6 operands: x in {0, 1, 2}, weights in {-2 .. 2}, integer
    biases. Every f32 sum is an integer below 2^24, exact in any order, so the
    card's rounded values are the plain version's bit for bit, while the bf16
    roundings tie rows whose accumulators differ."""
    gen = torch.Generator().manual_seed(seed)
    cin, chid, cout = widths
    x = torch.randint(0, 3, (n, p, cin), generator=gen).float()
    if twice:
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    ws = [torch.randint(lo, hi, shape, generator=gen).float().to(dev)
          for lo, hi, shape in ((-2, 3, (chid, cin)), (-8, 9, (chid,)), (-2, 3, (cout, chid)),
                                (-8, 9, (cout,)))]
    return x.to(dev, cdt), ws


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("n,p,widths,twice", [
    (8, 1024, (128, 512, 1024), False), (8, 1000, (128, 512, 1024), False),
    (6, 100, (128, 512, 1024), True), (5, 40, (128, 512, 1024), False),
    (20, 150, (64, 384, 640), False)])
def test_k6_fwd_idx_is_exact_on_integer_operands(dev, cdt, n, p, widths, twice):
    """The K6 forward (bf16: K1's `wgmma` body with the keyed argmax fold) on
    operands whose sums are exact: out and idx bit-equal to the plain
    version's, out bit-equal to K1, the lower of two equal points."""
    x, ws = _k6_int_case(400 + n + p, n, p, dev, cdt, widths, twice)
    before = tail_ops.LAUNCHES["dense_relu_dense_max_train_fwd"]
    with torch.no_grad():
        out, idx = tail_ops.dense_relu_dense_max_fwd(x, *ws, cdt)
        assert tail_ops.LAUNCHES["dense_relu_dense_max_train_fwd"] == before + 1
        out_p, idx_p = tail_ops.dense_relu_dense_max_fwd_plain(x, *ws, cdt)
        torch.cuda.synchronize()
        assert torch.equal(idx, idx_p) and torch.equal(out, out_p)
        assert torch.equal(out, enc_ops.dense_relu_dense_max(x, *ws, cdt))
        if cdt == torch.bfloat16:
            h = dense(dense(x, ws[0], ws[1], cdt, act=True), ws[2], ws[3], cdt)
            assert all(torch.equal(a, b) for a, b in zip(tail_ops.max_argmax_keyed(h), (out, idx)))
        if twice:
            assert idx.max() < p // 2


@pytest.mark.parametrize("p", [1024, 1000, 40])
def test_k6_fwd_bf16_vs_both_plain_versions(dev, p):
    """Random operands: out within the bf16 tolerance of the per-row plain
    version and of K1's folded plain version; idx as the plain one's but
    where the kernel's and the library's sums round apart, and there the
    plain activation at the kernel's row holds the plain max."""
    x, ws, _ = _tail_case("K6", torch.Generator().manual_seed(500 + p), 8, p, dev,
                          torch.bfloat16, False)
    bf = torch.bfloat16
    with torch.no_grad():
        out, idx = tail_ops.dense_relu_dense_max_fwd(x, *ws, bf)
        h = dense(dense(x, ws[0], ws[1], bf, act=True), ws[2], ws[3], bf).float()
        out_p, idx_p = tail_ops.max_argmax_keyed(h)
        assert all(torch.equal(a, b) for a, b in zip((out_p, idx_p), tail_ops.max_argmax(h)))
        _assert_close(out, out_p, bf)
        _assert_close(out, enc_ops.dense_relu_dense_max_folded_twin(x, *ws, bf), bf)
        assert idx.min() >= 0 and idx.max() < p
        assert (idx != idx_p).float().mean().item() < 1e-2
        at_idx = h.gather(1, idx.long()[:, None, :])[:, 0]
        _assert_close(at_idx, out_p, bf)


def test_k6_fwd_bf16_six_launches_are_bit_equal(dev):
    x, ws = _k6_int_case(7, 40, 1000, dev, torch.bfloat16)
    with torch.no_grad():
        first = tail_ops.dense_relu_dense_max_fwd(x, *ws, torch.bfloat16)
        for _ in range(5):
            again = tail_ops.dense_relu_dense_max_fwd(x, *ws, torch.bfloat16)
            assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_k6_fwd_bf16_holds_minus_zero_equal_to_plus_zero(dev):
    """Channel 0's rows: t = 2^-70 in h against -t / +t in W4 gives the f32
    accumulators -2^-140 / +2^-140, which round to -0 / +0 in bf16 (b4 = -0
    keeps the sign); every other row is -1. The lowest row among the zeros
    must win whatever its sign: cloud 0 a -0 row (3) ahead of +0 rows, cloud 1
    a +0 row (2) ahead of -0 rows. (Where the tensor cores flush the tiny
    products, every zero has one sign and the check still holds the tie.)"""
    n, p, cin, chid, cout = 2, 40, 64, 128, 128
    t = 2.0 ** -70
    zeros = {0: ([3, 17], [5, 30]), 1: ([9, 33], [2, 20])}     # cloud: (-0 rows, +0 rows)
    x = torch.zeros(n, p, cin)
    x[:, :, 2] = 1.0
    for k, (neg, pos) in zeros.items():
        x[k, neg, 2], x[k, neg, 0] = 0.0, t
        x[k, pos, 2], x[k, pos, 1] = 0.0, t
    w3 = torch.zeros(chid, cin)
    w3[0, 0] = w3[1, 1] = w3[2, 2] = 1.0
    w4 = torch.zeros(cout, chid)
    w4[0, 0], w4[0, 1], w4[0, 2] = -t, t, -1.0
    b4 = torch.zeros(cout)
    b4[0] = -0.0
    ws = [w.to(dev) for w in (w3, torch.zeros(chid), w4, b4)]
    bf = torch.bfloat16
    with torch.no_grad():
        out, idx = tail_ops.dense_relu_dense_max_fwd(x.to(dev, bf), *ws, bf)
        torch.cuda.synchronize()
        assert idx[0, 0] == 3 and idx[1, 0] == 2 and out[:, 0].abs().max() == 0
        assert torch.equal(idx, tail_ops.dense_relu_dense_max_fwd_plain(x, *[w.cpu() for w in ws],
                                                                        bf)[1].to(dev))


def test_k6_fwd_bf16_refuses_what_it_does_not_take(dev):
    bf = torch.bfloat16
    for widths in [(192, 512, 1024), (128, 1024, 1024), (128, 512, 4224)]:   # past K1's limits
        x, ws = _k6_int_case(0, 2, 64, dev, bf, widths)
        with pytest.raises(ValueError, match="exceed"):
            tail_ops.dense_relu_dense_max_fwd(x, *ws, bf)
    x, ws = _k6_int_case(1, 1, tail_ops.ARGMAX_MAX_ROWS + 64, dev, bf, (64, 128, 128))
    with pytest.raises(ValueError, match="argmax keys"):
        tail_ops.dense_relu_dense_max_fwd(x, *ws, bf)
    x, ws = _k6_int_case(2, 2, 64, dev, bf)
    with pytest.raises(ValueError, match="16-byte"):
        tail_ops.dense_relu_dense_max_fwd(_misaligned(x), *ws, bf)
    with pytest.raises(ValueError, match="16-byte"):                # K1, the same body
        enc_ops.dense_relu_dense_max(_misaligned(x), *ws, bf)
    with pytest.raises(RuntimeError, match="requires grad"):
        tail_ops.dense_relu_dense_max_fwd(x.float().requires_grad_(), *ws, torch.float32)
    with pytest.raises(RuntimeError, match="requires grad"):
        tail_ops.dense_relu_dense_max_fwd(x, ws[0].clone().requires_grad_(), *ws[1:], bf)
    out, _ = tail_ops.dense_relu_dense_max_fwd(x.float(), *ws, torch.float32)   # f32 takes it
    assert out.shape == (2, 1024)


def _k5_int_case(seed, n, p, dev, cdt, widths=(128, 1024), twice=False):
    """Exact-integer K5 operands (x in {0, 1, 2}, weights in {-2 .. 2}, integer
    biases: every f32 sum exact in any order), every fourth channel with
    weights at or below 0 and a bias of -50: negative on every row before the
    ReLU, so every row ties at 0 and idx is 0."""
    gen = torch.Generator().manual_seed(seed)
    cin, cout = widths
    x = torch.randint(0, 3, (n, p, cin), generator=gen).float()
    if twice:
        x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    w = torch.randint(-2, 3, (cout, cin), generator=gen).float()
    b = torch.randint(-8, 9, (cout,), generator=gen).float()
    w[::4], b[::4] = -w[::4].abs(), -50.0
    return x.to(dev, cdt), [w.to(dev), b.to(dev)]


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("n,p,widths,twice", [
    (8, 1024, (128, 1024), False), (8, 1000, (128, 1024), False), (6, 100, (128, 1024), True),
    (5, 40, (128, 1024), False), (20, 1000, (64, 640), False)])
def test_k5_fwd_idx_is_exact_on_integer_operands(dev, cdt, n, p, widths, twice):
    """The K5 forward (bf16: K2's `wgmma` kernel with the keyed fold after the
    ReLU) on operands whose sums are exact: out and idx bit-equal to the plain
    version's (bf16: also to the plain version of the keyed fold), out
    bit-equal to K2, idx 0 where every row is negative before the ReLU, the
    lower of two equal points."""
    x, ws = _k5_int_case(600 + n + p, n, p, dev, cdt, widths, twice)
    before = tail_ops.LAUNCHES["dense_relu_max_train_fwd"]
    with torch.no_grad():
        out, idx = tail_ops.dense_relu_max_fwd(x, *ws, cdt)
        assert tail_ops.LAUNCHES["dense_relu_max_train_fwd"] == before + 1
        out_p, idx_p = tail_ops.dense_relu_max_fwd_plain(x, *ws, cdt)
        torch.cuda.synchronize()
        assert torch.equal(idx, idx_p) and torch.equal(out, out_p)
        assert torch.equal(out, enc_ops.dense_relu_max(x, *ws, cdt))
        assert (idx[:, ::4] == 0).all() and (out[:, ::4] == 0).all()
        if cdt == torch.bfloat16:
            keyed = tail_ops.dense_relu_max_fwd_keyed_plain(x, *ws, cdt)
            assert torch.equal(keyed[0], out) and torch.equal(keyed[1], idx)
        if twice:
            assert idx.max() < p // 2


@pytest.mark.parametrize("p", [1024, 1000, 40])
def test_k5_fwd_bf16_vs_both_plain_versions(dev, p):
    """Random operands: out bit-equal to K2 and within the bf16 tolerance of
    the per-row plain version and of K2's folded plain version; idx as the
    plain one's but where the kernel's and the library's sums round apart,
    and there the plain activation at the kernel's row holds the plain max."""
    x, ws = _k2_case(700 + p, 8, p, dev, torch.bfloat16)
    bf = torch.bfloat16
    with torch.no_grad():
        out, idx = tail_ops.dense_relu_max_fwd(x, *ws, bf)
        h = dense(x, *ws, bf, act=True).float()
        out_p, idx_p = tail_ops.dense_relu_max_fwd_keyed_plain(x, *ws, bf)
        assert all(torch.equal(a, b) for a, b in zip((out_p, idx_p), tail_ops.max_argmax(h)))
        assert torch.equal(out, enc_ops.dense_relu_max(x, *ws, bf))
        _assert_close(out, out_p, bf)
        _assert_close(out, enc_ops.dense_relu_max_folded_twin(x, *ws, bf), bf)
        assert idx.min() >= 0 and idx.max() < p
        assert (idx != idx_p).float().mean().item() < 1e-2
        _assert_close(h.gather(1, idx.long()[:, None, :])[:, 0], out_p, bf)


def test_k5_fwd_bf16_six_launches_are_bit_equal(dev):
    x, ws = _k5_int_case(8, 300, 1000, dev, torch.bfloat16)
    with torch.no_grad():
        first = tail_ops.dense_relu_max_fwd(x, *ws, torch.bfloat16)
        for _ in range(5):
            again = tail_ops.dense_relu_max_fwd(x, *ws, torch.bfloat16)
            assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_k5_fwd_bf16_keys_minus_zero_as_plus_zero(dev):
    """Channel 0 of cloud 0: row 3's product is -2^-140, which rounds to -0 in
    bf16 (b = -0 keeps the sign), row 7 is +1, every other row -1: row 7 wins,
    a -0 keyed by its raw bits would beat it. Channel 1: every row at or
    below 0, row 0 among them: idx 0. (Where the tensor cores flush the tiny
    product, row 3 is a zero of either sign and the check still holds.)"""
    n, p, cin, cout = 2, 40, 64, 128
    t = 2.0 ** -70
    x = torch.zeros(n, p, cin)
    x[:, :, 2] = 1.0
    x[0, 3, 2], x[0, 3, 0] = 0.0, t
    x[0, 7, 2], x[0, 7, 1] = 0.0, 1.0
    w = torch.zeros(cout, cin)
    w[0, 0], w[0, 1], w[0, 2] = -t, 1.0, -1.0
    w[1, 0], w[1, 2] = -t, -1.0
    b = torch.zeros(cout)
    b[:2] = -0.0
    ws = [w.to(dev), b.to(dev)]
    bf = torch.bfloat16
    with torch.no_grad():
        out, idx = tail_ops.dense_relu_max_fwd(x.to(dev, bf), *ws, bf)
        torch.cuda.synchronize()
        assert idx[0, 0] == 7 and out[0, 0] == 1.0 and idx[0, 1] == 0 and out[0, 1] == 0
        assert torch.equal(idx, tail_ops.dense_relu_max_fwd_plain(x, w, b, bf)[1].to(dev))


def test_k5_fwd_bf16_refuses_what_it_does_not_take(dev):
    bf = torch.bfloat16
    x, ws = _k5_int_case(0, 2, 64, dev, bf, (192, 1024))
    with pytest.raises(ValueError, match="64 or 128"):
        tail_ops.dense_relu_max_fwd(x, *ws, bf)
    out, _ = tail_ops.dense_relu_max_fwd(x.float(), *ws, torch.float32)   # the f32 build takes it
    assert out.shape == (2, 1024)
    x, ws = _k5_int_case(1, 1, tail_ops.ARGMAX_MAX_ROWS + 64, dev, bf, (64, 128))
    with pytest.raises(ValueError, match="argmax keys"):
        tail_ops.dense_relu_max_fwd(x, *ws, bf)
    x, ws = _k5_int_case(2, 2, 64, dev, bf)
    with pytest.raises(ValueError, match="16-byte"):
        tail_ops.dense_relu_max_fwd(_misaligned(x), *ws, bf)
    with pytest.raises(RuntimeError, match="requires grad"):
        tail_ops.dense_relu_max_fwd(x, ws[0].clone().requires_grad_(), ws[1], bf)
    with pytest.raises(RuntimeError, match="requires grad"):
        tail_ops.dense_relu_max_fwd(x.float().requires_grad_(), *ws, torch.float32)


@pytest.mark.parametrize("fused_encoder_train", [True, False])
def test_train_step_launches_k3_and_k4(dev, fused_encoder_train):
    from catre_tpu_torch import ops
    from catre_tpu_torch.entry import train_entry

    ops.reset_launch_counts()
    state, history = train_entry(dev, batch_size=4, steps=1, num_pcl=256, num_kps=256,
                                 fused_encoder_train=fused_encoder_train)
    k5, k6 = (8, 4) if fused_encoder_train else (0, 0)
    assert ops.launch_counts() == {
        "dense_relu_dense_max": 0, "dense_relu_max": 0, "rot_head": 4, "rot_head_bwd": 4,
        "dense_relu_max_train_fwd": k5, "dense_relu_max_train_bwd": k5,
        "dense_relu_dense_max_train_fwd": k6, "dense_relu_dense_max_train_bwd": k6,
        "rot_head_grouped": 0, "rot_head_blocked": 0, "chain3_max": 0}
    assert all(torch.isfinite(v).all() for v in history[0].values())
    assert all(torch.isfinite(p).all() for p in state.params.values())


# P = 900: 15 tiles of 64 points an object, 45 in a block's sequence per object,
# so ring stage, mbarrier phase and warpgroup turn over at object boundaries
@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,p,k,group", [(8, 1024, 1024, 2), (8, 1024, 1024, 8), (12, 96, 40, 4),
                                         (8, 450, 450, 4)])
def test_rot_head_multi_kernel(dev, cdt, b, p, k, group):
    gen = torch.Generator().manual_seed(20 + b)
    head = _scaled_head(gen, p + k, dev)
    pf = (torch.randn(b, p + k, 64, generator=gen) * 0.5).to(dev, cdt)
    g2 = (torch.randn(b, 2, 1024, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, cdt)
        gterm = (g2 @ pack.w_g.T).contiguous()
        before = dict(multi_ops.LAUNCHES)
        grouped = multi_ops.rot_head_grouped(pf, gterm, pack, p, group)
        blocked = multi_ops.rot_head_blocked(pf, gterm, pack, p, group)
        assert multi_ops.LAUNCHES == {k_: v + 1 for k_, v in before.items()}
        assert torch.equal(grouped, blocked)
        assert torch.equal(grouped, multi_ops.rot_head_grouped(pf, gterm, pack, p, group))
        for other in multi_ops.OBJECTS_PER_BLOCK:     # an object's sums, whatever its block
            if b % other == 0:
                assert torch.equal(grouped, multi_ops.rot_head_blocked(pf, gterm, pack, p, other))
        _assert_close(grouped, multi_ops.rot_head_multi_twin(pf, gterm, pack, p), cdt)
        if cdt == torch.float32:       # without rounding K7/K8 compute K3's function
            _assert_close(grouped, rot_ops.rot_head(pf, gterm, pack, p), cdt)
        else:                          # and in bf16 they round the point reduction
            _assert_nearer(grouped, multi_ops.rot_head_multi_twin(pf, gterm, pack, p),
                           rot_ops.rot_head_twin(pf, gterm, pack, p))
        with pytest.raises(ValueError, match="objects per block"):
            multi_ops.rot_head_grouped(pf, gterm, pack, p, 3)
        with pytest.raises(ValueError, match="do not divide"):
            multi_ops.rot_head_blocked(pf[:b - 1], gterm[:b - 1], pack, p, group)


def test_rot_head_group_falls_back_to_k3_on_a_ragged_batch(dev):
    from catre_tpu_torch import ops

    gen = torch.Generator().manual_seed(3)
    head = _scaled_head(gen, 128, dev)
    pf = (torch.randn(6, 128, 64, generator=gen) * 0.5).to(dev)
    g = (torch.randn(2, 6, 1024, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        out = rot_ops.fused_conv_per_rot_head(pf, g[0], g[1], head, 64, torch.float32, group=4)
        counts = ops.launch_counts()
        assert counts["rot_head"] == 1 and counts["rot_head_grouped"] == 0
        assert torch.equal(out, rot_ops.fused_conv_per_rot_head(pf, g[0], g[1], head, 64,
                                                                torch.float32))


# the STN3d, STNkd and main columns at flagship widths, and one set of other
# widths (cin neither 3 nor a multiple of 64, c1 a multiple of 64 only), which
# the f32 build takes and the bf16 build refuses
@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("n,p", [(16, 1024), (5, 100)])
@pytest.mark.parametrize("widths,relu_last", [
    ((3, 64, 128, 1024), True), ((64, 64, 128, 1024), True), ((64, 128, 512, 1024), False),
    ((20, 192, 256, 384), False)])
def test_chain3_max_kernel(dev, cdt, n, p, widths, relu_last):
    gen = torch.Generator().manual_seed(n + widths[0])
    x = torch.randn(n, p, widths[0], generator=gen).to(dev, cdt)
    params = [t for cin, cout in zip(widths[:-1], widths[1:]) for t in _dense(gen, cin, cout, dev)]
    if cdt == torch.bfloat16 and widths[0] == 20:     # the bf16 designs take the columns' widths
        with pytest.raises(ValueError, match="neither the main column's"):
            chain_ops.chain3_max(x, *params, cdt, relu_last=relu_last)
        return
    before = chain_ops.LAUNCHES["chain3_max"]
    out = chain_ops.chain3_max(x, *params, cdt, relu_last=relu_last)
    assert chain_ops.LAUNCHES["chain3_max"] == before + 1
    ref = chain_ops.chain3_max_twin(x, *params, cdt, relu_last=relu_last)
    assert relu_last or ref.min() < 0      # the max is not clipped at 0
    _assert_close(out, ref, cdt)
    if cdt == torch.bfloat16:              # not flax Dense's rounding points (K1/K2's)
        h = dense(dense(x, *params[0:2], cdt, act=True), *params[2:4], cdt, act=True)
        _assert_nearer(out, ref, dense(h, *params[4:6], cdt, act=relu_last).amax(dim=1).float())


K9_COLUMNS = {"stn3d": ((3, 64, 128, 1024), True), "stnkd": ((64, 64, 128, 1024), True),
              "main": ((64, 128, 512, 1024), False)}


def _k9_case(column, n, p, dev, seed=0):
    widths, relu_last = K9_COLUMNS[column]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, p, widths[0], generator=gen)
    x = (x * 0.2 if widths[0] == 3 else torch.relu(x)).to(dev, torch.bfloat16)
    params = [t for cin, cout in zip(widths[:-1], widths[1:]) for t in _dense(gen, cin, cout, dev)]
    return x, params, relu_last


@pytest.mark.parametrize("column", list(K9_COLUMNS))
@pytest.mark.parametrize("p", [900, 136])
def test_chain3_max_bf16_at_point_counts_its_tile_does_not_divide(dev, column, p):
    x, params, relu_last = _k9_case(column, 6, p, dev)
    out = chain_ops.chain3_max(x, *params, torch.bfloat16, relu_last=relu_last)
    ref = chain_ops.chain3_max_twin(x, *params, torch.bfloat16, relu_last=relu_last)
    _assert_close(out, ref, torch.bfloat16)
    h = dense(dense(x, *params[0:2], torch.bfloat16, act=True), *params[2:4], torch.bfloat16,
              act=True)
    _assert_nearer(out, ref, dense(h, *params[4:6], torch.bfloat16, act=relu_last).amax(dim=1).float())


@pytest.mark.parametrize("column", list(K9_COLUMNS))
def test_chain3_max_bf16_six_launches_are_bit_equal(dev, column):
    x, params, relu_last = _k9_case(column, 40, 1000, dev)
    first = chain_ops.chain3_max(x, *params, torch.bfloat16, relu_last=relu_last)
    for _ in range(5):
        assert torch.equal(first, chain_ops.chain3_max(x, *params, torch.bfloat16,
                                                       relu_last=relu_last))


def test_chain3_max_bf16_refuses_a_misaligned_x(dev):
    for column in ("stnkd", "main"):
        x, params, relu_last = _k9_case(column, 2, 128, dev)
        with pytest.raises(ValueError, match="16-byte boundary"):
            chain_ops.chain3_max(_misaligned(x), *params, torch.bfloat16, relu_last=relu_last)
    x, params, relu_last = _k9_case("stn3d", 2, 128, dev)      # 6-byte rows, read as scalars
    out = chain_ops.chain3_max(_misaligned(x), *params, torch.bfloat16, relu_last=relu_last)
    assert torch.equal(out, chain_ops.chain3_max(x, *params, torch.bfloat16, relu_last=relu_last))


def test_variant_wrappers_raise_on_bad_input(dev):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 64, 64, generator=gen).to(dev)
    params = [t for cin, cout in ((64, 64), (64, 128), (128, 1024)) for t in _dense(gen, cin, cout, dev)]
    with pytest.raises(ValueError):
        chain_ops.chain3_max(x, *params, torch.float16)                     # compute dtype
    with pytest.raises(ValueError):
        chain_ops.chain3_max(x[:, :, :32], *params, torch.float32)          # widths do not chain
    bad = [params[0][:32], params[1][:32], params[2][:, :32], *params[3:]]
    with pytest.raises(ValueError):
        chain_ops.chain3_max(x, *bad, torch.float32)                        # c1 = 32
    with pytest.raises(RuntimeError, match="requires grad"):
        chain_ops.chain3_max(x.clone().requires_grad_(), *params, torch.float32)
    head = _scaled_head(gen, 128, dev)
    pf = torch.randn(4, 128, 64, generator=gen).to(dev)
    gterm = torch.randn(4, 2, 512, generator=gen).to(dev)
    with pytest.raises(RuntimeError, match="rot_head_train"):               # differentiable pack
        multi_ops.rot_head_grouped(pf, gterm, rot_ops.pack_rot_head(head, torch.float32), 64, 2)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, torch.float32)
        with pytest.raises(ValueError):
            multi_ops.rot_head_blocked(pf.bfloat16(), gterm, pack, 64, 2)   # pf not in cdt


@pytest.mark.parametrize("cdt", DTYPES)
def test_rot_head_multi_takes_any_point_count(dev, cdt):
    """No point weights in shared memory: K7/K8 take a P that K3 takes, here
    4096 (the old kernel refused it)."""
    gen = torch.Generator().manual_seed(8)
    head = _scaled_head(gen, 4096, dev)
    pf = (torch.randn(2, 4096, 64, generator=gen) * 0.5).to(dev, cdt)
    g2 = (torch.randn(2, 2, 1024, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, cdt)
        gterm = (g2 @ pack.w_g.T).contiguous()
        _assert_close(multi_ops.rot_head_grouped(pf, gterm, pack, 2048, 2),
                      multi_ops.rot_head_multi_twin(pf, gterm, pack, 2048), cdt)


@pytest.mark.parametrize("overrides,want", [
    ({"fused_encoder": True}, {"chain3_max": 12, "rot_head": 4}),
    ({"fused_block_size": 4}, {"rot_head_blocked": 4, "dense_relu_dense_max": 4,
                               "dense_relu_max": 8}),
    ({"fused_block_size": 4, "batch_size": 6}, {"rot_head": 4, "dense_relu_dense_max": 4,
                                                "dense_relu_max": 8})])
def test_refine_variants_launch_their_kernels(dev, overrides, want):
    from catre_tpu_torch import ops
    from catre_tpu_torch.entry import entry

    overrides = dict(overrides)
    refine, args = entry(dev, batch_size=overrides.pop("batch_size", 8), num_pcl=256,
                         num_kps=256, **overrides)
    ops.reset_launch_counts()
    poses, scales = refine(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**dict.fromkeys(ops.launch_counts(), 0), **want}
    assert torch.isfinite(poses).all() and torch.isfinite(scales).all()


# ---- the sampler on the card against the port on the CPU


def _sampler_frames():
    from catre_tpu_torch.entry import example_frames

    return example_frames(4, 120, 160, m=8, seed=3, objs=(2, 8), size_px=(16, 70))


def _same(card, cpu):
    for a, b in zip(card, cpu):
        a = a.cpu()
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("train_aug", [False, True])
def test_group_sampler_card_equals_cpu(dev, window, train_aug):
    """The group sampler (fused windowed form, full frame, depth
    augmentation) on the card against the CPU, with one set of draws."""
    from catre_tpu_torch.data.loader import LoaderConfig, make_group_sampler

    f = _sampler_frames()
    cfg = LoaderConfig(num_pcl=64, sample_window=window, max_objs_per_image=8)
    gen = torch.Generator().manual_seed(0)
    n = 64 * 64 if window else 120 * 160
    pri = torch.rand(4, 8, n, generator=gen)
    aug = None
    if train_aug:
        aug = {"fill_draw": torch.randn(4, 120, 160, generator=gen),
               "drop_coin_draw": torch.tensor([0.1, 0.9, 0.1, 0.9]),
               "keep_draw": torch.rand(4, 120, 160, generator=gen),
               "noise_coin_draw": torch.tensor([0.1, 0.1, 0.95, 0.95]),
               "noise_level_draw": torch.rand(4, generator=gen) * 0.01,
               "noise_draw": torch.randn(4, 120, 160, generator=gen)}
    args = (f["depth"], f["K"], f["packed"], f["poses"], f["scales"], f["mask_bbox"])
    cpu = make_group_sampler(cfg, train_aug, device="cpu")(*args, priorities=pri, aug_draws=aug)
    card = make_group_sampler(cfg, train_aug, device=dev)(
        *args, priorities=pri.to(dev),
        aug_draws=None if aug is None else {k: v.to(dev) for k, v in aug.items()})
    _same(card, cpu)


def test_window_forms_agree_on_the_card(dev):
    """Fused from-depth, materialized windowed and candidates + select give
    the same outputs on the card; the generator's own draws stay inside,
    repeat nothing while enough points are inside and cycle scarce rows."""
    from catre_tpu_torch.data.loader import (LoaderConfig, make_candidates_builder,
                                             make_presampled_group_sampler,
                                             sample_group_from_cloud, sample_group_from_depth,
                                             to_device)
    from catre_tpu_torch.ops.sampling import batch_ball_crop_candidates

    f = _sampler_frames()
    cfg = LoaderConfig(num_pcl=128, sample_window=64, max_objs_per_image=8)
    d = [to_device(f[k], dev) for k in ("depth", "K", "packed", "poses", "scales", "mask_bbox")]
    gen = torch.Generator(device=dev).manual_seed(1)
    pri = torch.rand(4, 8, 64 * 64, device=dev, generator=gen)
    fused = sample_group_from_depth(cfg, *d, priorities=pri)
    _same(sample_group_from_cloud(cfg, False, *d[:5], priorities=pri), [o.cpu() for o in fused])
    table = [to_device(f[k], dev) for k in ("depth", "packed", "K", "poses", "scales",
                                            "mask_bbox")]
    rows = torch.arange(4, device=dev)
    cand = make_candidates_builder(cfg, device=dev)(*table, rows)
    pre = make_presampled_group_sampler(cfg, 160, 64, device=dev)(*cand, rows, priorities=pri)
    _same(pre, [o.cpu() for o in fused])
    pts, idx, n_in = sample_group_from_depth(cfg, *d, generator=gen)
    _, inside, _, _ = batch_ball_crop_candidates(d[0], d[1], d[2], d[5], d[3], d[4], 0.6, 64)
    idx_w = ((idx // 160 - cand[3][..., :1]) * 64 + idx % 160 - cand[3][..., 1:])
    assert torch.gather(inside, -1, idx_w)[n_in > 0].all()
    for row, n in zip(idx.flatten(0, 1).tolist(), n_in.flatten().tolist()):
        assert len(set(row)) == min(n, 128) or n == 0


# ---- the test loader on the card against the same loader on the CPU

def _loader_split(tmp_path, n=8):
    from catre_tpu_torch.entry import write_example_split

    return write_example_split(str(tmp_path), n, h=120, w=160, m=4, seed=3)


def _loader(records, device, **kw):
    import numpy as np

    from catre_tpu_torch.data.loader import CATRELoader, LoaderConfig

    fields = {k: kw.pop(k) for k in list(kw) if k in LoaderConfig.__dataclass_fields__}
    cfg = LoaderConfig(num_pcl=64, sample_window=-1, aug_depth=False, max_objs_per_image=4,
                       **fields)
    table = np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32)
    return CATRELoader(records, cfg, phase="test", ims_per_batch=2, device=device,
                       mean_points=table, **kw)


def _same_batches(card, cpu):
    import numpy as np

    assert len(card) == len(cpu) >= 4
    for a, b in zip(card, cpu):
        assert a["scene_im_ids"] == b["scene_im_ids"] and set(a) == set(b)
        for k in set(a) - {"pcl", "scene_im_ids", "file_names"}:
            np.testing.assert_array_equal(a[k], b[k])
        x, y = torch.as_tensor(a["pcl"]).cpu(), torch.as_tensor(b["pcl"]).cpu()
        assert x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("cache,device_batches", [("", True), ("", False), ("ram", True),
                                                  ("device", True), ("device", False)])
def test_test_loader_card_equals_cpu(dev, tmp_path, cache, device_batches):
    """The loader's own draws are integer hashes: the card's batches are the
    CPU's bit for bit, through the pinned uploader, the device cache and the
    frozen presampled path."""
    from catre_tpu_torch.data.loader import clear_decoded_caches

    records = _loader_split(tmp_path)
    kw = dict(cache_decoded=cache, device_batches=device_batches, num_workers=2)
    card = [dict(b, pcl=b["pcl"].clone() if torch.is_tensor(b["pcl"]) else b["pcl"])
            for b in _loader(records, dev, **kw)]
    if device_batches:
        assert card[0]["pcl"].device.type == "cuda"
    _same_batches(card, list(_loader(records, "cpu", **kw)))
    clear_decoded_caches()


def test_pipelined_batches_equal_serial_on_the_card(dev, tmp_path):
    """Two groups in flight through the two pinned slots: the same batches
    as one group at a time, from the third group on too."""
    records = _loader_split(tmp_path, n=10)
    loader = _loader(records, dev, num_workers=3, device_batches=True)
    piped = [dict(b, pcl=b["pcl"].clone()) for b in loader]
    loader.reset_stream()
    _same_batches(piped, list(loader.iter_serial()))


def test_counter_draws_are_the_cpus_bits_on_the_card(dev):
    import numpy as np

    from catre_tpu_torch.data.loader import counter_draws, image_key

    keys = np.stack([image_key(5, g) for g in range(6)])
    card = counter_draws(keys, (6, 8, 224 * 224), dev)
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu().view(torch.int32),
                       counter_draws(keys, (6, 8, 224 * 224), "cpu").view(torch.int32))


# ---- the evaluator's inference loop on the card

def _eval_preds(records, device, model, prefetch=2, **kw):
    from catre_tpu_torch.engine.refiner import make_refine_fn
    from catre_tpu_torch.eval.evaluator import CATREEvaluator, run_inference

    table = _loader_table()
    ev = CATREEvaluator(records, n_iters=2)
    run_inference(make_refine_fn(model, 2), _loader(records, device, device_batches=True, **kw),
                  ev, 2, warmup=0, compute_probe_every=1, prefetch=prefetch, mean_table=table)
    return ev._preds


def _loader_table():
    import numpy as np

    return np.random.default_rng(0).normal(size=(6, 1024, 3)).astype(np.float32)


def _eval_model(device, **overrides):
    from catre_tpu_torch.entry import flagship_config
    from catre_tpu_torch.models.catre import init_model

    return init_model(flagship_config(num_pcl=64, **overrides), seed=0, device=device)


@pytest.mark.parametrize("cache", ["device", ""])
def test_run_inference_card_equals_cpu_f32(dev, tmp_path, cache):
    """The f32 refine on the card (K1-K3's f32 builds) against the CPU (their
    plain versions) through `run_inference`: iteration 0 and the host fields
    exact, the refined poses and scales within 5e-4, the dtypes equal."""
    import numpy as np

    from catre_tpu_torch.data.loader import clear_decoded_caches

    records = _loader_split(tmp_path)
    card = _eval_preds(records, dev, _eval_model(dev, dtype=None), cache_decoded=cache)
    cpu = _eval_preds(records, "cpu", _eval_model("cpu", dtype=None), cache_decoded=cache)
    clear_decoded_caches()
    assert len(card) == len(cpu) == 3 and len(card[0]) == len(records)
    for it, (a, b) in enumerate(zip(card, cpu)):
        assert sorted(a) == sorted(b)
        for sid in a:
            for k in a[sid]:
                x, y = a[sid][k], b[sid][k]
                assert x.dtype == y.dtype and x.shape == y.shape, (it, sid, k)
                if it == 0 or k not in ("pred_RTs", "pred_scales"):
                    np.testing.assert_array_equal(x, y)
                else:
                    np.testing.assert_allclose(x, y, atol=5e-4, rtol=0)


def test_run_inference_prefetch_0_equals_2_on_the_card(dev, tmp_path):
    """The pinned result buffers are rewritten only after their copy's event:
    prefetch 0 and 2 give the same predictions bit for bit (bf16 refine)."""
    from catre_tpu_torch.data.loader import clear_decoded_caches

    records = _loader_split(tmp_path, n=10)
    model = _eval_model(dev)
    got = [_eval_preds(records, dev, model, prefetch=p, cache_decoded="device")
           for p in (0, 2)]
    clear_decoded_caches()
    for a, b in zip(*got):
        assert sorted(a) == sorted(b) and a
        for sid in a:
            for k in a[sid]:
                x, y = a[sid][k], b[sid][k]
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (sid, k)
