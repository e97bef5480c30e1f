"""Port kernel modules on the CPU (their plain twins) vs the JAX package's
Pallas kernels in interpret mode, at the flagship channel widths:
  - K2 / K1 twins vs fused_dense_relu_max / fused_dense_relu_dense_max: 1e-5;
  - the port encoder (kernel tails) vs pointnet_encode_fused: 2e-5;
  - the K3 twin vs fused_conv_per_rot_head, weights x50: 2e-4;
  - the n_pcl split changes the K3 result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.models.heads import ConvOutPerRotHead as JaxRotHead
from catre_tpu.models.pointnet import PointNetFeat as JaxPointNetFeat
from catre_tpu.ops.pallas_encoder_epilogue import (
    fused_dense_relu_dense_max,
    fused_dense_relu_max,
    pointnet_encode_fused,
)
from catre_tpu.ops.pallas_heads import fused_conv_per_rot_head as jax_rot_head
from catre_tpu_torch.models.heads import ConvOutPerRotHead
from catre_tpu_torch.models.pointnet import PointNetFeat
from catre_tpu_torch.ops import encoder_epilogue as enc_ops
from catre_tpu_torch.ops import rot_head as rot_ops
from catre_tpu_torch.utils.convert import params_from_jax

F32 = torch.float32


def _np_tree(tree, scale=1.0):
    return jax.tree_util.tree_map(lambda a: np.array(a) * scale, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,p", [(6, 64), (5, 100)])
def test_dense_relu_max_twin(n, p):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, p, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 1024)) * 0.05).astype(np.float32)   # flax (in, out)
    b = (rng.normal(size=(1024,)) * 0.1).astype(np.float32)
    ref = fused_dense_relu_max(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    out = enc_ops.dense_relu_max(_t(x), _t(w.T), _t(b), F32)
    assert out.dtype == F32 and out.shape == (n, 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,p", [(4, 64), (3, 72)])
def test_dense_relu_dense_max_twin(n, p):
    rng = np.random.default_rng(10 + n)
    x = rng.normal(size=(n, p, 128)).astype(np.float32)
    w3 = (rng.normal(size=(128, 512)) * 0.05).astype(np.float32)
    b3 = (rng.normal(size=(512,)) * 0.1).astype(np.float32)
    w4 = (rng.normal(size=(512, 1024)) * 0.05).astype(np.float32)
    b4 = (rng.normal(size=(1024,)) * 0.1).astype(np.float32)
    ref = fused_dense_relu_dense_max(*map(jnp.asarray, (x, w3, b3, w4, b4)), interpret=True)
    out = enc_ops.dense_relu_dense_max(_t(x), _t(w3.T), _t(b3), _t(w4.T), _t(b4), F32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("feature_transform", [True, False])
def test_encoder_matches_pointnet_encode_fused(feature_transform):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 128, 3)) * 0.2).astype(np.float32)
    jenc = JaxPointNetFeat(out_dim=1024, global_feat=False, feature_transform=feature_transform,
                           return_parts=True)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    pf_ref, gf_ref = pointnet_encode_fused(params, jnp.asarray(x),
                                           feature_transform=feature_transform, interpret=True)
    enc = PointNetFeat(torch.Generator().manual_seed(0), feature_transform=feature_transform)
    enc.load_state_dict(params_from_jax(_np_tree(params), enc))
    with torch.no_grad():
        for tails in (enc_ops.ENCODER_TAIL_KERNELS, enc_ops.ENCODER_TAIL_TWINS):
            pf, gf = enc(_t(x), tails)
            np.testing.assert_allclose(pf.numpy(), np.asarray(pf_ref), atol=2e-5, rtol=0)
            np.testing.assert_allclose(gf.numpy(), np.asarray(gf_ref), atol=2e-5, rtol=0)


def _rot_head_case(seed, b, p, k):
    rng = np.random.default_rng(seed)
    pf = (rng.normal(size=(b, p + k, 64)) * 0.5).astype(np.float32)
    g_pcl = (rng.normal(size=(b, 1024)) * 0.5).astype(np.float32)
    g_kps = (rng.normal(size=(b, 1024)) * 0.5).astype(np.float32)
    jhead = JaxRotHead(num_points=p + k)
    params = jhead.init(jax.random.PRNGKey(seed), *map(jnp.asarray, (pf, g_pcl, g_kps)), p)
    params = _np_tree(params["params"], 50.0)   # signal well above the 1e-3 init
    head = ConvOutPerRotHead(torch.Generator().manual_seed(0), num_points=p + k)
    head.load_state_dict(params_from_jax(params, head))
    return pf, g_pcl, g_kps, params, head


@pytest.mark.parametrize("b,p,k", [(4, 128, 128), (3, 96, 64)])
def test_rot_head_twin_matches_pallas(b, p, k):
    pf, g_pcl, g_kps, params, head = _rot_head_case(31, b, p, k)
    ref = jax_rot_head(*map(jnp.asarray, (pf, g_pcl, g_kps)), params, n_pcl=p, interpret=True)
    with torch.no_grad():
        out = rot_ops.fused_conv_per_rot_head(_t(pf), _t(g_pcl), _t(g_kps), head, p, F32)
        plain = head(_t(pf), _t(g_pcl), _t(g_kps), p)
    assert out.shape == (b, 6) and out.dtype == F32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    np.testing.assert_allclose(plain.numpy(), out.numpy(), atol=2e-4, rtol=0)


def test_rot_head_split_position_matters():
    pf, g_pcl, g_kps, _, head = _rot_head_case(1, 2, 32, 32)
    with torch.no_grad():
        a = rot_ops.fused_conv_per_rot_head(_t(pf), _t(g_pcl), _t(g_kps), head, 32, F32)
        b = rot_ops.fused_conv_per_rot_head(_t(pf), _t(g_pcl), _t(g_kps), head, 64, F32)
    assert not torch.allclose(a, b)


def test_rot_head_rejects_other_widths():
    head = ConvOutPerRotHead(torch.Generator().manual_seed(0), feat_dim=128, num_points=64)
    with pytest.raises(ValueError, match="flagship widths"):
        rot_ops.pack_rot_head(head, F32)
