"""CUDA kernels K1, K2 and K3 vs their plain PyTorch twins on the card.

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
from catre_tpu_torch.models.layers import Dense
from catre_tpu_torch.ops import encoder_epilogue as enc_ops
from catre_tpu_torch.ops import rot_head as rot_ops

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


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,p,k", [(8, 1024, 1024), (3, 96, 40)])
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
