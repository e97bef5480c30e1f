"""The port's differentiable encoder tails (K5/K6, `ops/encoder_epilogue_train.py`)
on the CPU, where they run their plain versions, vs the JAX package's
custom-VJP Pallas kernels in interpret mode (f32), same numpy inputs:
  - `DenseReluMaxTrain` vs `dense_relu_max_t`, `DenseReluDenseMaxTrain` vs
    `dense_relu_dense_max_t`: values 1e-5, argmax rows equal, gradients 2e-4
    (the tolerances of `tests/test_encoder_vjp.py`), one shape with P not a
    multiple of 64;
  - ties (duplicated points, an all-negative channel): both packages send the
    gradient to the lowest row only, where `amax` under autograd splits it;
  - `PointNetFeat(..., ENCODER_TAIL_TRAIN)` vs `pointnet_encode_fused_train`:
    outputs 1e-5, gradients to every parameter and to x 5e-4;
  - K5's backward in the bf16 kernel's own order
    (`dense_relu_max_bwd_critical_plain`: gate, route the gated d, the sums
    over each critical row's segment, dx in x's dtype) vs JAX's VJP (f32,
    2e-4) and vs the dense plain version (f32 1e-6, bf16 3 bf16 spacings, x
    max(1, max|dense|); its bf16 dx equal to the dense f32 dx rounded once),
    and its routing on tie-rich data with channels whose gate is closed on
    every row;
  - both Functions and both backward wrappers return dx in x's dtype;
  - K6's backward in the bf16 kernel's own order
    (`dense_relu_dense_max_bwd_critical_plain`: route, g, gate, products on
    the critical rows) vs the dense plain version and vs JAX's VJP, 2e-4, also
    over a hypothesis sweep of small widths, and its routing (`route_rows`,
    what the kernel's routing pass writes) checked key by key.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from catre_tpu.models.pointnet import PointNetFeat as JaxPointNetFeat
from catre_tpu.ops import pallas_encoder_epilogue_vjp as jax_vjp
from catre_tpu_torch import ops
from catre_tpu_torch.models.pointnet import PointNetFeat
from catre_tpu_torch.ops import encoder_epilogue as enc_ops
from catre_tpu_torch.ops import encoder_epilogue_train as train_ops
from catre_tpu_torch.utils.convert import params_from_jax

F32 = torch.float32


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _k5_case(seed, n, p, cout=256):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, p, 128)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(128, cout)) * 0.1).astype(np.float32)   # flax (in, out)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    co = rng.normal(size=(n, cout)).astype(np.float32)
    return x, w, b, co


def _k6_case(seed, n, p, c3=256, c4=384):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, p, 128)) * 0.3).astype(np.float32)
    w3 = (rng.normal(size=(128, c3)) * 0.1).astype(np.float32)
    b3 = (rng.normal(size=(c3,)) * 0.1).astype(np.float32)
    w4 = (rng.normal(size=(c3, c4)) * 0.1).astype(np.float32)
    b4 = (rng.normal(size=(c4,)) * 0.1).astype(np.float32)
    co = rng.normal(size=(n, c4)).astype(np.float32)
    return x, w3, b3, w4, b4, co


def _jax_k5(x, w, b, co):
    """-> (out, idx, (dx, dw, db)) of `dense_relu_max_t` in interpret mode."""
    args = tuple(map(jnp.asarray, (x, w, b)))
    out, idx = jax_vjp._fwd_call(jax_vjp._fwd_kernel_1, args[0], [args[1], args[2].reshape(1, -1)],
                                 w.shape[1], jax_vjp._FWD_BLOCK, True, jnp.float32)
    grads = jax.grad(lambda *a: jnp.sum(jax_vjp.dense_relu_max_t(*a, True, jnp.float32) * co),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), np.asarray(idx), [np.asarray(g) for g in grads]


def _jax_k6(x, w3, b3, w4, b4, co):
    args = tuple(map(jnp.asarray, (x, w3, b3, w4, b4)))
    params = [args[1], args[2].reshape(1, -1), args[3], args[4].reshape(1, -1)]
    out, idx = jax_vjp._fwd_call(jax_vjp._fwd_kernel_2, args[0], params, w4.shape[1],
                                 jax_vjp._FWD_BLOCK, True, jnp.float32)
    grads = jax.grad(
        lambda *a: jnp.sum(jax_vjp.dense_relu_dense_max_t(*a, True, jnp.float32) * co),
        argnums=tuple(range(5)))(*args)
    return np.asarray(out), np.asarray(idx), [np.asarray(g) for g in grads]


def _port_k5(x, w, b, co):
    """-> (out, idx, (dx, dw in flax layout, db)) of `DenseReluMaxTrain` on the CPU."""
    xt, wt, bt = _t(x, True), _t(w.T, True), _t(b, True)
    ops.reset_launch_counts()
    out = train_ops.dense_relu_max_train(xt, wt, bt, F32)
    (out * _t(co)).sum().backward()
    assert not any(ops.launch_counts().values())       # the CPU runs the plain versions
    with torch.no_grad():
        out2, idx = train_ops.dense_relu_max_fwd(xt, wt, bt, F32)
    assert torch.equal(out, out2) and idx.dtype == torch.int32
    return (out.detach().numpy(), idx.numpy(),
            [xt.grad.numpy(), wt.grad.numpy().T, bt.grad.numpy()])


def _port_k6(x, w3, b3, w4, b4, co):
    ts = [_t(x, True), _t(w3.T, True), _t(b3, True), _t(w4.T, True), _t(b4, True)]
    ops.reset_launch_counts()
    out = train_ops.dense_relu_dense_max_train(*ts, F32)
    (out * _t(co)).sum().backward()
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        out2, idx = train_ops.dense_relu_dense_max_fwd(*ts, F32)
    assert torch.equal(out, out2) and idx.dtype == torch.int32
    g = [t.grad.numpy() for t in ts]
    return out.detach().numpy(), idx.numpy(), [g[0], g[1].T, g[2], g[3].T, g[4]]


def _assert_matches(port, ref):
    np.testing.assert_allclose(port[0], ref[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(port[1], ref[1])
    assert len(port[2]) == len(ref[2])
    for i, (a, r) in enumerate(zip(port[2], ref[2])):
        assert a.shape == r.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, r, atol=2e-4, rtol=0, err_msg=f"gradient {i}")


@pytest.mark.parametrize("n,p", [(4, 64), (3, 100)])
def test_dense_relu_max_train_matches_jax(n, p):
    case = _k5_case(20 + n, n, p)
    _assert_matches(_port_k5(*case), _jax_k5(*case))


@pytest.mark.parametrize("n,p", [(4, 64), (3, 100)])
def test_dense_relu_dense_max_train_matches_jax(n, p):
    case = _k6_case(30 + n, n, p)
    _assert_matches(_port_k6(*case), _jax_k6(*case))


def _amax_dx(tail, x, *weights_and_co):
    """dx of the plain tail (`amax` under autograd) for the same cotangent."""
    *weights, co = weights_and_co
    xt = _t(x, True)
    ws = [_t(w.T if w.ndim == 2 else w) for w in weights]
    (tail(xt, *ws, F32) * _t(co)).sum().backward()
    return xt.grad.numpy()


def test_dense_relu_max_train_routes_ties_to_the_lowest_row():
    n, p = 3, 48
    x, w, b, co = _k5_case(41, n, p)
    x[:, p // 2:] = x[:, :p // 2]          # every point twice: every max is tied
    b[:16] = -50.0                         # channels negative everywhere: relu ties at 0 on all rows
    port, ref = _port_k5(x, w, b, co), _jax_k5(x, w, b, co)
    _assert_matches(port, ref)
    assert port[1].max() < p // 2                      # the lowest of the tied rows
    assert (port[1][:, :16] == 0).all() and (port[0][:, :16] == 0).all()
    dx = port[2][0]
    assert np.abs(dx[:, p // 2:]).max() == 0 and np.abs(dx[:, :p // 2]).max() > 0
    assert np.abs(port[2][1][:, :16]).max() == 0       # dW of the gated channels
    split = _amax_dx(enc_ops.dense_relu_max_twin, x, w, b, co)
    np.testing.assert_allclose(split[:, p // 2:], split[:, :p // 2], atol=1e-6)   # amax splits
    np.testing.assert_allclose(2 * split[:, :p // 2], dx[:, :p // 2], atol=2e-4)
    assert np.abs(split - dx).max() > 1e-2


def test_dense_relu_dense_max_train_routes_ties_to_the_lowest_row():
    n, p = 2, 40
    x, w3, b3, w4, b4, co = _k6_case(42, n, p)
    x[:, p // 2:] = x[:, :p // 2]
    port, ref = _port_k6(x, w3, b3, w4, b4, co), _jax_k6(x, w3, b3, w4, b4, co)
    _assert_matches(port, ref)
    assert port[1].max() < p // 2
    dx = port[2][0]
    assert np.abs(dx[:, p // 2:]).max() == 0 and np.abs(dx[:, :p // 2]).max() > 0
    split = _amax_dx(enc_ops.dense_relu_dense_max_twin, x, w3, b3, w4, b4, co)
    np.testing.assert_allclose(split[:, p // 2:], split[:, :p // 2], atol=1e-6)
    assert np.abs(split - dx).max() > 1e-2


def test_train_tails_refuse_other_devices_and_dtypes():
    x = torch.randn(2, 16, 128)
    w, b = torch.randn(256, 128), torch.randn(256)
    with pytest.raises(ValueError, match="no kernel"):
        train_ops.dense_relu_max_fwd(x.to("meta"), w, b, F32)
    with pytest.raises(ValueError, match="no kernel"):
        train_ops.dense_relu_max_bwd(x.to("meta"), w, b, torch.zeros(2, 256, dtype=torch.int32),
                                     torch.zeros(2, 256), F32)


@pytest.mark.parametrize("feature_transform", [True, False])
def test_encoder_train_tails_match_pointnet_encode_fused_train(feature_transform):
    rng = np.random.default_rng(5)
    n, p = 2, 64
    x = (rng.normal(size=(n, p, 3)) * 0.2).astype(np.float32)
    jenc = JaxPointNetFeat(out_dim=1024, global_feat=False, feature_transform=feature_transform,
                           return_parts=True)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    c1 = rng.normal(size=(n, p, 64)).astype(np.float32)
    c2 = rng.normal(size=(n, 1024)).astype(np.float32)

    def loss(prm, xx):
        pf, gf = jax_vjp.pointnet_encode_fused_train(prm, xx, feature_transform, True, jnp.float32)
        return jnp.sum(pf * c1) + jnp.sum(gf * c2), (pf, gf)

    (_, (pf_ref, gf_ref)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1),
                                                                has_aux=True)(params, jnp.asarray(x))

    enc = PointNetFeat(torch.Generator().manual_seed(0), feature_transform=feature_transform)
    enc.load_state_dict(params_from_jax(_np_tree(params), enc))
    xt = _t(x, True)
    pf, gf = enc(xt, train_ops.ENCODER_TAIL_TRAIN)
    np.testing.assert_allclose(pf.detach().numpy(), np.asarray(pf_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gf.detach().numpy(), np.asarray(gf_ref), atol=1e-5, rtol=0)
    ((pf * _t(c1)).sum() + (gf * _t(c2)).sum()).backward()
    want = params_from_jax(_np_tree(g_params), enc)
    for name, prm in enc.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=5e-4, rtol=0)


def _critical(x, w3, b3, w4, b4, idx, co, cdt=F32):
    """dense_relu_dense_max_bwd_critical_plain on flax-layout numpy inputs ->
    the gradients in flax layout, as `_jax_k6` returns them."""
    g = train_ops.dense_relu_dense_max_bwd_critical_plain(
        _t(x), _t(w3.T), _t(b3), _t(w4.T), _t(b4), _t(idx), _t(co), cdt)
    return [g[0].numpy(), g[1].numpy().T, g[2].numpy(), g[3].numpy().T, g[4].numpy()]


@pytest.mark.parametrize("n,p,ties", [(4, 64, False), (3, 100, False), (2, 40, True)])
def test_k6_backward_on_critical_rows_matches_jax_and_the_dense_plain_version(n, p, ties):
    x, w3, b3, w4, b4, co = _k6_case(50 + n, n, p)
    if ties:
        x[:, p // 2:] = x[:, :p // 2]
    co[:, ::5] = 0.0                       # dead channels: routed nowhere
    out, idx, ref = _jax_k6(x, w3, b3, w4, b4, co)
    crit = _critical(x, w3, b3, w4, b4, idx, co)
    dense_plain = _port_k6(x, w3, b3, w4, b4, co)[2]
    for i, (a, r, d) in enumerate(zip(crit, ref, dense_plain)):
        assert a.shape == r.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, r, atol=2e-4, rtol=0, err_msg=f"gradient {i} vs JAX")
        np.testing.assert_allclose(a, d, atol=2e-4, rtol=0, err_msg=f"gradient {i} vs dense")
    # dx is zero on every row no live channel points at, and on the higher tied rows
    hit = np.zeros((n, p), bool)
    for k in range(n):
        hit[k, idx[k][co[k] != 0]] = True
    assert np.abs(crit[0][~hit]).max(initial=0.0) == 0 and np.abs(crit[0][hit]).max() > 0
    if ties:
        assert idx.max() < p // 2 and np.abs(crit[0][:, p // 2:]).max() == 0


@pytest.mark.parametrize("n,p,c,seed", [(5, 64, 128, 0), (3, 7, 256, 1)])
def test_route_rows_puts_every_live_channel_in_one_segment(n, p, c, seed):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, p, size=(n, c)).astype(np.int32))
    d4 = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    d4[torch.from_numpy(rng.random((n, c)) < 0.3)] = 0.0
    d4[0] = 0.0                            # a cloud with no live channel
    chan, seg, rows, count = train_ops.route_rows(idx, d4)
    for k in range(n):
        live = np.flatnonzero(d4[k].numpy() != 0)
        want_rows = np.unique(idx[k].numpy()[live])
        assert count[k].item() == want_rows.size          # idx.unique() over the live channels
        m = count[k].item()
        np.testing.assert_array_equal(rows[k, :m].numpy(), want_rows)   # ascending
        assert (rows[k, m:] == -1).all() and seg[k, m].item() == live.size
        starts = seg[k, :m + 1].numpy()
        assert (np.diff(starts) > 0).all() and (starts[0] == 0 or m == 0)
        seen = []
        for i in range(m):                                # a segment: one row, channels ascending
            cs = chan[k, starts[i]:starts[i + 1]].numpy()
            assert (np.diff(cs) > 0).all()
            assert (idx[k].numpy()[cs] == want_rows[i]).all()
            seen.extend(cs.tolist())
        assert sorted(seen) == live.tolist()               # each live channel exactly once
        assert (chan[k, live.size:] == -1).all()


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 3), p=st.integers(1, 40), seed=st.integers(0, 2**16),
       bf16=st.booleans(), dead=st.floats(0.0, 0.9))
def test_k6_backward_on_critical_rows_over_small_shapes(n, p, seed, bf16, dead):
    rng = np.random.default_rng(seed)
    cdt = torch.bfloat16 if bf16 else F32
    x = torch.from_numpy(np.maximum(rng.normal(size=(n, p, 64)), 0).astype(np.float32))
    w3, b3 = (torch.from_numpy((rng.normal(size=s) * 0.2).astype(np.float32)) for s in ((128, 64), 128))
    w4, b4 = (torch.from_numpy((rng.normal(size=s) * 0.2).astype(np.float32)) for s in ((128, 128), 128))
    d_out = torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32))
    d_out[torch.from_numpy(rng.random((n, 128)) < dead)] = 0.0
    xc = x.to(cdt)
    _, idx = train_ops.dense_relu_dense_max_fwd(xc, w3, b3, w4, b4, cdt)
    crit = train_ops.dense_relu_dense_max_bwd_critical_plain(xc, w3, b3, w4, b4, idx, d_out, cdt)
    dense_plain = train_ops.dense_relu_dense_max_bwd_plain(xc, w3, b3, w4, b4, idx, d_out, cdt)
    for i, (a, r) in enumerate(zip(crit, dense_plain)):
        assert a.shape == r.shape and a.dtype == F32
        torch.testing.assert_close(a, r, atol=2e-4, rtol=0, msg=f"gradient {i}")


def test_k6_backward_schedule_fills_the_sms_once():
    # the train step's widths on 132 SMs: a cloud pass block per SM, 8 x 16 dW3
    # blocks, 32 x 4 dW4 blocks
    assert train_ops.k6_bwd_schedule(1024, 512, 1024, 132) == (132, 16, 4)
    for n, chid, cout, sms in [(1, 512, 1024, 132), (3, 384, 640, 132), (1000, 128, 128, 8)]:
        grid, g3, g4 = train_ops.k6_bwd_schedule(n, chid, cout, sms)
        assert 1 <= grid <= min(n, sms) and 1 <= g3 <= n and 1 <= g4 <= n
        assert g3 * chid // 64 <= max(sms, chid // 64)
        assert g4 * (chid // 128) * (cout // 128) <= max(sms, (chid // 128) * (cout // 128))


BF16_SPACING = 2.0 ** -7         # bf16's spacing at 1.0: 8 significant bits


def _k5_tied_case(seed, n, p, cin=128, cout=256):
    """K5 operands rich in ties: every point twice, the first 16 channels
    negative on every row (their gate is closed at idx 0), every sixth
    cotangent zero."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(n, p, cin)), 0).astype(np.float32)
    x[:, p // 2:2 * (p // 2)] = x[:, :p // 2]
    w = (rng.normal(size=(cout, cin)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    w[:16], b[:16] = -np.abs(w[:16]), -50.0
    co = rng.normal(size=(n, cout)).astype(np.float32)
    co[:, ::6] = 0.0
    return x, w, b, co


@pytest.mark.parametrize("n,p", [(4, 64), (3, 100)])
def test_k5_backward_on_critical_rows_matches_jax(n, p):
    x, w, b, co = _k5_case(60 + n, n, p)
    _, idx, ref = _jax_k5(x, w, b, co)
    got = train_ops.dense_relu_max_bwd_critical_plain(_t(x), _t(w.T), _t(b), _t(idx), _t(co), F32)
    got = [got[0].numpy(), got[1].numpy().T, got[2].numpy()]
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.shape == r.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, r, atol=2e-4, rtol=0, err_msg=f"gradient {i}")


@pytest.mark.parametrize("cdt", [F32, torch.bfloat16])
@pytest.mark.parametrize("n,p,cin,cout", [(4, 64, 128, 256), (3, 100, 64, 384), (2, 1000, 128, 1024)])
def test_k5_backward_on_critical_rows_matches_the_dense_plain_version(cdt, n, p, cin, cout):
    x, w, b, co = map(torch.from_numpy, _k5_tied_case(70 + p, n, p, cin, cout))
    xc = x.to(cdt)
    _, idx = train_ops.dense_relu_max_fwd(xc, w, b, cdt)
    crit = train_ops.dense_relu_max_bwd_critical_plain(xc, w, b, idx, co, cdt)
    dense_plain = train_ops.dense_relu_max_bwd_plain(xc, w, b, idx, co, cdt)
    assert crit[0].dtype == cdt and crit[1].dtype == crit[2].dtype == F32
    tol = 1e-6 if cdt == F32 else 3 * BF16_SPACING
    for i, (a, r) in enumerate(zip(crit, dense_plain)):
        assert a.shape == r.shape
        torch.testing.assert_close(a.float(), r, atol=tol * max(1.0, r.abs().max().item()), rtol=0,
                                   msg=f"gradient {i}")
    assert torch.equal(crit[0], dense_plain[0].to(cdt))     # dx: the f32 sum rounded once
    assert crit[0].abs().max() > 0


@pytest.mark.parametrize("n,p", [(3, 41), (2, 200)])
def test_k5_backward_routes_only_live_channels(n, p):
    """On tie-rich data with a ragged P: the keys that `route_rows` keeps are
    the live channels (gate open, cotangent not zero), each once; the dead
    ones point at row 0 or at a lower tied row and add nothing; dx is zero on
    every row that no live channel points at, and on every upper tied row."""
    x, w, b, co = map(torch.from_numpy, _k5_tied_case(80 + p, n, p))
    cdt = torch.bfloat16
    xc = x.to(cdt)
    _, idx = train_ops.dense_relu_max_fwd(xc, w, b, cdt)
    upper = slice(p // 2, 2 * (p // 2))             # the upper copy of each tied pair
    assert (idx[:, :16] == 0).all() and not ((idx >= upper.start) & (idx < upper.stop)).any()
    wc = w.to(cdt).float()
    pre = (torch.gather(xc.float(), 1, idx.long()[:, :, None].expand(-1, -1, 128)) * wc).sum(2) + b
    d = torch.where(pre > 0, co, 0.0).to(cdt).float()
    live = d != 0
    assert not live[:, :16].any() and not live[:, ::6].any() and live.any()
    chan, seg, rows, count = train_ops.route_rows(idx, d)
    dx = train_ops.dense_relu_max_bwd_critical_plain(xc, w, b, idx, co, cdt)[0]
    for k in range(n):
        kept = chan[k][chan[k] >= 0]
        assert sorted(kept.tolist()) == torch.nonzero(live[k]).flatten().tolist()
        hit = torch.zeros(p, dtype=torch.bool)
        hit[idx[k][live[k]].long()] = True
        assert rows[k, :count[k]].tolist() == torch.nonzero(hit).flatten().tolist()
        assert dx[k][~hit].abs().max() == 0 and dx[k][hit].abs().amax(dim=1).min() > 0
    assert dx[:, upper].abs().max() == 0


@pytest.mark.parametrize("cdt", [F32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["K5", "K6"])
def test_train_tails_return_dx_in_x_dtype(kind, cdt):
    """Both Functions hand autograd dx in x's dtype, and both backward
    wrappers return it so (no cast after them); weight gradients f32."""
    if kind == "K5":
        x, w, b, co = _k5_case(90, 2, 40)
        ws = [_t(w.T, True), _t(b, True)]
        train, fwd, bwd = train_ops.dense_relu_max_train, train_ops.dense_relu_max_fwd, \
            train_ops.dense_relu_max_bwd
    else:
        x, w3, b3, w4, b4, co = _k6_case(90, 2, 40)
        ws = [_t(w3.T, True), _t(b3, True), _t(w4.T, True), _t(b4, True)]
        train, fwd, bwd = train_ops.dense_relu_dense_max_train, \
            train_ops.dense_relu_dense_max_fwd, train_ops.dense_relu_dense_max_bwd
    xt = _t(x).to(cdt).requires_grad_(True)
    (train(xt, *ws, cdt) * _t(co)).sum().backward()
    assert xt.grad.dtype == cdt and all(wt.grad.dtype == F32 for wt in ws)
    with torch.no_grad():
        xd = xt.detach()
        _, idx = fwd(xd, *ws, cdt)
        grads = bwd(xd, *[wt.detach() for wt in ws], idx, _t(co), cdt)
    assert grads[0].dtype == cdt and all(g.dtype == F32 for g in grads[1:])
    assert torch.equal(grads[0], xt.grad)
