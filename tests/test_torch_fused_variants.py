"""The port's two remaining inference variants on the CPU (their plain
versions) vs the JAX package's Pallas kernels in interpret mode:
  - the K7/K8 plain version vs `fused_conv_per_rot_head(group=G)`: 1e-5, and
    vs `fused_conv_per_rot_head_blocked(block_size=G)`, weights x50: 3e-4, at
    G = 2, 4 and 8; in bf16 vs both Pallas bodies run in bf16 (the JAX
    wrappers compute in f32 in interpret mode, so the test forces interpret
    mode under the TPU path's compute dtype, compiled without excess
    precision): within 1/8 of a bf16 spacing of max|out|, and far nearer
    them than K3's plain version;
  - the K7/K8 plain version on the whole batch is, bit for bit, its results
    on G-object chunks concatenated (each object on its own, as the kernel's
    sums are whatever the block);
  - the `B % G != 0` fallback equals the per-object op and counts as K3; a G
    that divides B but that the kernel is not built for (3) runs on the CPU
    and matches JAX `group=3`, 2e-4, as does the model at fused_block_size=3;
  - in bf16 the rounded point reduction moves the result (so it cannot be
    dropped unnoticed) by less than the card's 3e-2 gate;
  - the K9 plain version vs `chain3_max`: 1e-5; in bf16 vs `_chain_kernel` run
    in bf16 (forced interpret mode, as for the rot heads) at the three
    columns' widths: within 1/8 of a bf16 spacing of max|out|;
  - `STN.forward_fused` / `PointNetFeat.forward_fused` vs `stn_forward_fused`
    (1e-5) / `pointnet_forward_fused` (1e-4);
  - the slice: the 2-iteration refine under `fused_encoder` and under
    `fused_block_size` vs JAX `make_refine_fn`: 5e-4;
  - a differentiable call ignores both fields, and the bare wrappers refuse it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from catre_tpu.engine.refiner import make_refine_fn as jax_make_refine_fn
from catre_tpu.models import CATREConfig as JaxConfig
from catre_tpu.models import CATREDisRShared as JaxModel
from catre_tpu.models import init_params
from catre_tpu.models.heads import ConvOutPerRotHead as JaxRotHead
from catre_tpu.models.pointnet import STN as JaxSTN
from catre_tpu.models.pointnet import PointNetFeat as JaxPointNetFeat
from catre_tpu.ops.pallas_encoder import chain3_max as jax_chain3_max
from catre_tpu.ops.pallas_encoder import pointnet_forward_fused, stn_forward_fused
from catre_tpu.ops.pallas_heads import fused_conv_per_rot_head as jax_rot_head
from catre_tpu.ops.pallas_heads_blocked import fused_conv_per_rot_head_blocked as jax_blocked
from catre_tpu_torch import ops
from catre_tpu_torch.engine.refiner import make_refine_fn
from catre_tpu_torch.models.catre import CATREConfig, init_model
from catre_tpu_torch.models.heads import ConvOutPerRotHead
from catre_tpu_torch.models.layers import dense
from catre_tpu_torch.models.pointnet import STN, PointNetFeat
from catre_tpu_torch.ops import encoder_chain as chain_ops
from catre_tpu_torch.ops import rot_head as rot_ops
from catre_tpu_torch.ops import rot_head_multi as multi_ops
from catre_tpu_torch.utils.convert import params_from_jax

from test_engine import _synthetic_batch

F32, BF16 = torch.float32, torch.bfloat16


def _np_tree(tree, scale=1.0):
    return jax.tree_util.tree_map(lambda a: np.array(a) * scale, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot_head_case(seed, b, p, k, scale):
    rng = np.random.default_rng(seed)
    pf = (rng.normal(size=(b, p + k, 64)) * 0.5).astype(np.float32)
    g_pcl = (rng.normal(size=(b, 1024)) * 0.5).astype(np.float32)
    g_kps = (rng.normal(size=(b, 1024)) * 0.5).astype(np.float32)
    jhead = JaxRotHead(num_points=p + k)
    params = jhead.init(jax.random.PRNGKey(seed), *map(jnp.asarray, (pf, g_pcl, g_kps)), p)
    params = _np_tree(params["params"], scale)
    head = ConvOutPerRotHead(torch.Generator().manual_seed(0), num_points=p + k)
    head.load_state_dict(params_from_jax(params, head))
    return pf, g_pcl, g_kps, params, head


@pytest.mark.parametrize("group", [2, 4, 8])
def test_grouped_rot_head_matches_pallas(group):
    """K7 at the size of `tests/test_pallas_heads.py::
    test_grouped_kernel_matches_per_object` and to its tolerance."""
    pf, g_pcl, g_kps, params, head = _rot_head_case(0, 8, 64, 64, 1.0)
    ref = jax_rot_head(*map(jnp.asarray, (pf, g_pcl, g_kps)), params, n_pcl=64, interpret=True,
                       group=group)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = rot_ops.fused_conv_per_rot_head(_t(pf), _t(g_pcl), _t(g_kps), head, 64, F32,
                                              group=group)
    assert out.shape == (8, 6) and out.dtype == F32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert not any(ops.launch_counts().values())      # the CPU runs the plain version


@pytest.mark.parametrize("block_size", [2, 4, 8])
def test_blocked_rot_head_matches_pallas(block_size):
    """K8 with weights x50, to the tolerance of `tests/test_pallas_blocked.py`."""
    pf, g_pcl, g_kps, params, head = _rot_head_case(61, 8, 64, 64, 50.0)
    ref = jax_blocked(*map(jnp.asarray, (pf, g_pcl, g_kps)), params, n_pcl=64,
                      block_size=block_size, interpret=True)
    with torch.no_grad():
        out = rot_ops.fused_conv_per_rot_head_blocked(_t(pf), _t(g_pcl), _t(g_kps), head, 64,
                                                      F32, block_size)
        grouped = rot_ops.fused_conv_per_rot_head(_t(pf), _t(g_pcl), _t(g_kps), head, 64, F32,
                                                  group=block_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-4, rtol=0)
    assert torch.equal(out, grouped)                  # one function behind both wrappers


@pytest.mark.parametrize("cdt", [F32, BF16])
def test_multi_twin_is_the_same_on_any_chunking(cdt):
    """Each object of the K7/K8 plain version is computed on its own: the
    whole batch gives the G-object chunks' results concatenated, bit for bit.
    The kernel relies on the same property: an object's sums have one order,
    whatever block it lands in, so that G = 2, 4 and 8 give the same bits."""
    pf, g_pcl, g_kps, _, head = _rot_head_case(7, 8, 64, 64, 50.0)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, cdt)
        gterm = torch.stack([_t(g_pcl), _t(g_kps)], dim=1) @ pack.w_g.T
        x = _t(pf).to(cdt)
        whole = multi_ops.rot_head_multi_twin(x, gterm, pack, 64)
        for g in multi_ops.OBJECTS_PER_BLOCK:
            chunks = [multi_ops.rot_head_multi_twin(x[i:i + g], gterm[i:i + g], pack, 64)
                      for i in range(0, 8, g)]
            assert torch.equal(whole, torch.cat(chunks)), g


def _pallas_bf16(fn, pf, g_pcl, g_kps, params, **kw):
    """A JAX rot-head wrapper's Pallas body computed in bf16 on the CPU. The
    wrappers switch to f32 in interpret mode (`cdt = jnp.float32 if interpret
    else compute_dtype`), so they are called on their TPU path with every
    `pallas_call` forced into interpret mode, and compiled without excess
    precision: XLA on the CPU may otherwise keep an f32 value where the body
    rounds to bf16."""
    def fwd(a, b, c):
        return fn(a, b, c, params, n_pcl=64, interpret=False, compute_dtype=jnp.bfloat16, **kw)

    args = list(map(jnp.asarray, (pf, g_pcl, g_kps)))
    compiled = jax.jit(fwd).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args))


@pytest.mark.parametrize("form", ["grouped", "blocked"])
def test_multi_twin_matches_the_pallas_bodies_in_bf16(form, monkeypatch):
    """The K7/K8 plain version in bf16 vs the Pallas grouped / blocked body in
    bf16 (4 objects a grid step), weights x50: within 1/8 of a bf16 spacing of
    max|out| (2^(floor(log2 max|out|) - 7)), and on average under a quarter of
    the distance of K3's plain version (f32 point reduction) to the same
    body."""
    call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: call(*a, **{**k, "interpret": True}))
    pf, g_pcl, g_kps, params, head = _rot_head_case(11, 8, 64, 64, 50.0)
    with torch.no_grad():
        if form == "grouped":
            ref = _pallas_bf16(jax_rot_head, pf, g_pcl, g_kps, params, group=4)
            out = rot_ops.fused_conv_per_rot_head(_t(pf), _t(g_pcl), _t(g_kps), head, 64, BF16,
                                                  group=4)
        else:
            ref = _pallas_bf16(jax_blocked, pf, g_pcl, g_kps, params, block_size=4)
            out = rot_ops.fused_conv_per_rot_head_blocked(_t(pf), _t(g_pcl), _t(g_kps), head, 64,
                                                          BF16, 4)
        pack = rot_ops.pack_rot_head(head, BF16)
        gterm = torch.stack([_t(g_pcl), _t(g_kps)], dim=1) @ pack.w_g.T
        k3 = rot_ops.rot_head_twin(_t(pf).to(BF16), gterm, pack, 64).numpy()
    out = out.numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(out - ref).max() <= spacing / 8
    assert np.abs(out - ref).mean() <= 0.25 * np.abs(k3 - ref).mean()


def test_ragged_batch_falls_back_to_the_per_object_op():
    """G = 4 does not divide B = 6: the grouped op is the per-object op and the
    blocked op raises. G = 3 divides it and runs on the CPU, as in JAX (any G
    that divides B), where the kernel is built for 2, 4 and 8 only."""
    pf, g_pcl, g_kps, params, head = _rot_head_case(3, 6, 64, 64, 50.0)
    args = (_t(pf), _t(g_pcl), _t(g_kps), head, 64, F32)
    ref = jax_rot_head(*map(jnp.asarray, (pf, g_pcl, g_kps)), params, n_pcl=64, interpret=True, group=4)
    ref3 = jax_rot_head(*map(jnp.asarray, (pf, g_pcl, g_kps)), params, n_pcl=64, interpret=True,
                        group=3)
    with torch.no_grad():
        out = rot_ops.fused_conv_per_rot_head(*args, group=4)
        assert torch.equal(out, rot_ops.fused_conv_per_rot_head(*args))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
        with pytest.raises(ValueError, match="do not divide"):
            rot_ops.fused_conv_per_rot_head_blocked(*args, 4)
        out3 = rot_ops.fused_conv_per_rot_head(*args, group=3)
        np.testing.assert_allclose(out3.numpy(), np.asarray(ref3), atol=2e-4, rtol=0)
        assert torch.equal(out3, rot_ops.fused_conv_per_rot_head_blocked(*args, 3))
    # the model takes K3's op when fused_block_size does not divide B, and the
    # blocked op at fused_block_size = 3, which divides B = 6
    model = init_model(CATREConfig(num_pcl=64, num_kps=64, fused_heads=True), seed=2)
    xs = [torch.randn(6, 64, 3, generator=torch.Generator().manual_seed(1)) * 0.2,
          torch.randn(6, 64, 3, generator=torch.Generator().manual_seed(2)) * 0.2,
          torch.full((6, 3), 0.2), torch.zeros(6, 3)]
    with torch.no_grad():
        per_object = model(*xs)
        model.cfg = dataclasses.replace(model.cfg, fused_block_size=4)
        ragged = model(*xs)
        model.cfg = dataclasses.replace(model.cfg, fused_block_size=3)
        blocked3 = model(*xs)
    assert all(torch.equal(a, b) for a, b in zip(per_object, ragged))
    for a, b in zip(per_object, blocked3):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


def test_rounded_point_reduction_shows_in_bf16():
    """f32: the K7/K8 plain version is K3's; bf16: rounding y and pw moves
    the result, by less than the card's kernel-vs-plain gate."""
    pf, g_pcl, g_kps, _, head = _rot_head_case(5, 4, 128, 128, 50.0)
    with torch.no_grad():
        for cdt in (F32, BF16):
            pack = rot_ops.pack_rot_head(head, cdt)
            gterm = torch.stack([_t(g_pcl), _t(g_kps)], dim=1) @ pack.w_g.T
            k3 = rot_ops.rot_head_twin(_t(pf).to(cdt), gterm, pack, 128)
            multi = multi_ops.rot_head_multi_twin(_t(pf).to(cdt), gterm, pack, 128)
            diff = (k3 - multi).abs().max().item()
            if cdt == F32:
                assert diff == 0.0
            else:
                assert 0.0 < diff < 3e-2 * max(1.0, k3.abs().max().item()), diff


def _chain_case(seed, n, p, widths):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p, widths[0])).astype(np.float32)
    layers = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        layers += [(rng.normal(size=(cin, cout)) * 0.2).astype(np.float32),   # flax (in, out)
                   (rng.normal(size=(cout,)) * 0.1).astype(np.float32)]
    return x, layers


@pytest.mark.parametrize("relu_last", [False, True])
@pytest.mark.parametrize("widths", [(16, 32, 24, 48), (3, 64, 128, 1024)])
def test_chain3_max_twin_matches_pallas(widths, relu_last):
    x, layers = _chain_case(41, 3, 64, widths)
    ref = jax_chain3_max(jnp.asarray(x), *map(jnp.asarray, layers), relu_last=relu_last,
                         interpret=True)
    port_layers = [_t(a.T) if a.ndim == 2 else _t(a) for a in layers]
    out = chain_ops.chain3_max(_t(x), *port_layers, F32, relu_last=relu_last)
    assert out.dtype == F32 and out.shape == (3, widths[-1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    if not relu_last:
        assert out.min() < 0           # a running max that started at 0 would have clipped it


def test_chain3_max_rounds_after_the_relu_only():
    """bf16: one rounding per hidden layer, after bias and ReLU in f32, and
    none in the last layer, unlike `models.layers.dense`."""
    x, layers = _chain_case(7, 2, 32, (16, 64, 128, 128))
    w1, b1, w2, b2, w3, b3 = [_t(a.T) if a.ndim == 2 else _t(a) for a in layers]
    out = chain_ops.chain3_max_twin(_t(x), w1, b1, w2, b2, w3, b3, BF16)

    def bf(t):
        return t.to(BF16).float()

    h = bf(torch.relu(bf(_t(x)) @ bf(w1).T + b1))
    h = bf(torch.relu(h @ bf(w2).T + b2))
    want = (h @ bf(w3).T + b3).amax(dim=1)
    assert out.dtype == F32
    torch.testing.assert_close(out, want, atol=1e-6, rtol=0)
    assert not torch.equal(out, bf(out))              # the result is not bf16-quantised


@pytest.mark.parametrize("widths,relu_last", [((3, 64, 128, 1024), True),
                                               ((64, 64, 128, 1024), True),
                                               ((64, 128, 512, 1024), False)])
def test_chain3_max_twin_matches_the_pallas_body_in_bf16(widths, relu_last, monkeypatch):
    """K9's plain version in bf16 vs `_chain_kernel` in bf16 at the three
    columns' widths: the JAX wrapper on its TPU path with `pallas_call` forced
    into interpret mode, compiled without excess precision (`_pallas_bf16`).
    Within 1/8 of a bf16 spacing of max|out| (2^(floor(log2 max|out|) - 7)):
    the two differ only in the order of the f32 sums, which may flip a hidden
    value's rounding; on average under 1/100 of the distance of the same
    layers rounded as flax Dense (K1/K2's rounding) to the same body."""
    call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: call(*a, **{**k, "interpret": True}))
    x, layers = _chain_case(43, 2, 64, widths)
    if widths[0] != 3:
        x = np.maximum(x, 0.0)                        # the columns' inputs after a ReLU

    def fwd(*args):
        return jax_chain3_max(*args, relu_last=relu_last, interpret=False,
                              compute_dtype=jnp.bfloat16)

    args = list(map(jnp.asarray, (x, *layers)))
    ref = np.asarray(jax.jit(fwd).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))
    port_layers = [_t(a.T) if a.ndim == 2 else _t(a) for a in layers]
    with torch.no_grad():
        out = chain_ops.chain3_max(_t(x), *port_layers, BF16, relu_last=relu_last).numpy()
        h = dense(dense(_t(x).to(BF16), *port_layers[0:2], BF16, act=True), *port_layers[2:4],
                  BF16, act=True)
        flax = dense(h, *port_layers[4:6], BF16, act=relu_last).amax(dim=1).float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(out - ref).max() <= spacing / 8
    assert np.abs(out - ref).mean() <= 0.01 * np.abs(flax - ref).mean()


@pytest.mark.parametrize("k", [3, 64])
def test_stn_forward_fused_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 48, k)).astype(np.float32)
    params = JaxSTN(k=k).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = stn_forward_fused(params, jnp.asarray(x), k=k, interpret=True)
    stn = STN(k, torch.Generator().manual_seed(0))
    stn.load_state_dict(params_from_jax(_np_tree(params), stn))
    with torch.no_grad():
        out = stn.forward_fused(_t(x), F32)
    assert out.shape == (2, k, k)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("feature_transform", [True, False])
def test_pointnet_forward_fused_matches_jax(feature_transform):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 48, 3)) * 0.3).astype(np.float32)
    jenc = JaxPointNetFeat(feature_transform=feature_transform, return_parts=True)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    pf_ref, gf_ref = pointnet_forward_fused(params, jnp.asarray(x),
                                            feature_transform=feature_transform, interpret=True)
    enc = PointNetFeat(torch.Generator().manual_seed(0), feature_transform=feature_transform)
    enc.load_state_dict(params_from_jax(_np_tree(params), enc))
    with torch.no_grad():
        pf, gf = enc.forward_fused(_t(x), F32)
        pf_plain, gf_plain = enc(_t(x))
    np.testing.assert_allclose(pf.numpy(), np.asarray(pf_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gf.numpy(), np.asarray(gf_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gf.numpy(), gf_plain.numpy(), atol=1e-4, rtol=0)


def test_forward_fused_keeps_the_surrounding_layers_in_f32():
    """A bf16 model's fused-column encoder returns f32 point features that
    are not bf16-quantised (conv1 and the transforms ran in f32)."""
    enc = PointNetFeat(torch.Generator().manual_seed(0), dtype=BF16)
    x = (torch.randn(2, 32, 3, generator=torch.Generator().manual_seed(1)) * 0.3).to(BF16)
    with torch.no_grad():
        pf, gf = enc.forward_fused(x, BF16)
        pf_plain, _ = enc(x)
    assert pf.dtype == F32 and gf.dtype == F32 and pf_plain.dtype == BF16
    assert not torch.equal(pf, pf.to(BF16).float())


def _pair(**overrides):
    jcfg = JaxConfig(num_pcl=64, num_kps=64, **overrides)
    jmodel = JaxModel(jcfg)
    params = init_params(jmodel, jcfg, jax.random.PRNGKey(0))
    cfg = CATREConfig(num_pcl=64, num_kps=64, **overrides)
    model = init_model(cfg, seed=1)
    model.load_state_dict(params_from_jax(_np_tree(params), model))
    return jcfg, jmodel, params, model


@pytest.mark.parametrize("overrides", [{"fused_encoder": True}, {"fused_block_size": 2},
                                       {"fused_encoder": True, "fused_block_size": 4}])
def test_refine_variants_match_jax(overrides):
    jcfg, jmodel, params, model = _pair(fused_heads=True, **overrides)
    batch = _synthetic_batch(b=4, p=64, k=64, seed=5)
    names = ("pcl", "obj_kps", "obj_pose", "obj_scale", "K", "obj_mean_scales")
    poses_ref, scales_ref = jax_make_refine_fn(jmodel, jcfg, n_iter=2)(
        params, *(batch[n] for n in names))
    poses, scales = make_refine_fn(model, n_iter=2)(*(_t(batch[n]) for n in names))
    assert poses.shape == (3, 4, 3, 4) and scales.shape == (3, 4, 3)
    np.testing.assert_allclose(poses.numpy(), np.asarray(poses_ref), atol=5e-4, rtol=0)
    np.testing.assert_allclose(scales.numpy(), np.asarray(scales_ref), atol=5e-4, rtol=0)


def test_fused_encoder_comes_before_the_tail_kernels(monkeypatch):
    """`fused_encoder` wins over `fused_encoder_epilogue`, and only under
    `fused_heads` (`catre.py:202-210`)."""
    calls = []
    real = PointNetFeat.forward_fused

    def spy(self, x, cdt):
        calls.append(cdt)
        return real(self, x, cdt)

    monkeypatch.setattr(PointNetFeat, "forward_fused", spy)
    xs = [torch.randn(2, 64, 3) * 0.2, torch.randn(2, 64, 3) * 0.2, torch.full((2, 3), 0.2),
          torch.zeros(2, 3)]
    cfg = CATREConfig(num_pcl=64, num_kps=64, fused_encoder=True)
    model = init_model(cfg, seed=0)
    with torch.no_grad():
        model(*xs)
        assert calls == []                            # fused_heads is off
        model.cfg = dataclasses.replace(cfg, fused_heads=True)
        model(*xs)
    assert calls == [F32]


@pytest.mark.parametrize("overrides", [{"fused_encoder": True}, {"fused_block_size": 2}])
def test_a_differentiable_call_ignores_the_inference_variants(overrides, monkeypatch):
    cfg = CATREConfig(num_pcl=64, num_kps=64, fused_heads=True, fused_heads_train=True,
                      fused_encoder_train=True, **overrides)
    model = init_model(cfg, seed=0)

    def refuse(*args, **kwargs):
        raise AssertionError("an inference-only op ran in a differentiable call")

    monkeypatch.setattr(PointNetFeat, "forward_fused", refuse)
    monkeypatch.setattr("catre_tpu_torch.models.catre.fused_conv_per_rot_head_blocked", refuse)
    xs = [torch.randn(2, 64, 3) * 0.2, torch.randn(2, 64, 3) * 0.2, torch.full((2, 3), 0.2),
          torch.zeros(2, 3)]
    out = model(*xs)
    sum(o.sum() for o in out).backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    plain = init_model(dataclasses.replace(cfg, fused_block_size=1, fused_encoder=False), seed=0)
    for a, b in zip(out, plain(*xs)):
        assert torch.equal(a, b)


def test_bare_wrappers_refuse_a_differentiable_call():
    """On a device with a kernel, a tensor that requires grad raises before
    anything launches (`meta` stands in for the card: the check comes first)."""
    x, layers = _chain_case(1, 2, 16, (64, 64, 128, 128))
    w1, b1, w2, b2, w3, b3 = [(_t(a.T) if a.ndim == 2 else _t(a)).to("meta") for a in layers]
    with pytest.raises(RuntimeError, match="requires grad"):
        chain_ops.chain3_max(_t(x).to("meta"), w1.requires_grad_(), b1, w2, b2, w3, b3, F32)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        chain_ops.chain3_max(_t(x).to("meta"), w1, b1, w2, b2, w3, b3, F32)
    pf, g_pcl, g_kps, _, head = _rot_head_case(2, 4, 32, 32, 1.0)
    head.to("meta")
    pack = rot_ops.pack_rot_head(head, F32)           # differentiable in the head
    args = (_t(pf).to("meta"), torch.empty(4, 2, 512, device="meta"), pack, 32, 2)
    for fn in (multi_ops.rot_head_grouped, multi_ops.rot_head_blocked):
        with pytest.raises(RuntimeError, match="rot_head_train"):
            fn(*args)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, F32)
        with pytest.raises(ValueError, match="no kernel"):
            multi_ops.rot_head_grouped(args[0], args[1], pack, 32, 2)
