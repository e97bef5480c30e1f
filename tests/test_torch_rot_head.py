"""What surrounds the Hopper K3 (`csrc/rot_head.cu`) and can be held on the CPU:
  - `rot_head` on CPU tensors (its plain version) vs the JAX package's
    `fused_conv_per_rot_head` in interpret mode, f32, weights x50, 2e-4, at
    point counts that the kernel's 64-point tile does not divide and with the
    cloud / keypoint boundary inside a tile;
  - the erf polynomial the bf16 kernel evaluates in place of `erff`, read out
    of the CUDA source (`csrc/rot_head_wgmma.cuh`) and evaluated in float32 as the kernel does: 1.5e-7
    absolute against erf, and the GELU built on it against the exact-erf GELU
    of the plain version;
  - the plain version of the two chained tensor-core products
    (`wgmma_chain`), which is what the card test holds the kernel's fragment
    bookkeeping to, against a float64 computation;
  - the address arithmetic of `csrc/wgmma_tile.cuh` (swizzled weight panels,
    accumulator and A fragments), modelled in numpy: the panel layout is a
    permutation that round-trips, and the accumulator of one product, packed
    as the header says, is the A operand of the next.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catre_tpu.ops.pallas_heads import fused_conv_per_rot_head as jax_rot_head
from catre_tpu_torch.models.layers import gelu_exact
from catre_tpu_torch.ops import rot_head as rot_ops

from test_torch_kernels import _rot_head_case, _t

CSRC = Path(rot_ops.__file__).resolve().parents[1] / "csrc"
F32 = torch.float32


@pytest.mark.parametrize("b,p,k", [(3, 100, 37), (2, 20, 9), (2, 64, 70)])
def test_rot_head_on_cpu_matches_pallas_at_ragged_point_counts(b, p, k):
    pf, g_pcl, g_kps, params, head = _rot_head_case(41, b, p, k)
    ref = jax_rot_head(*map(jnp.asarray, (pf, g_pcl, g_kps)), params, n_pcl=p, interpret=True)
    with torch.no_grad():
        pack = rot_ops.pack_rot_head(head, F32)
        gterm = torch.stack([_t(g_pcl), _t(g_kps)], dim=1) @ pack.w_g.T
        out = rot_ops.rot_head(_t(pf), gterm, pack, p)
    assert out.shape == (b, 6) and out.dtype == F32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


def _erf_poly():
    """The coefficients of `kErfPoly` as the CUDA source spells them."""
    src = (CSRC / "rot_head_wgmma.cuh").read_text()
    body = re.search(r"kErfPoly\[8\]\s*=\s*\{([^}]*)\}", src).group(1)
    coef = [np.float32(tok.strip().rstrip("f")) for tok in body.split(",")]
    assert len(coef) == 8
    return coef


def _erf7(x):
    """The erf inside the kernel's `gelu7`, in float32 (numpy rounds each
    product and sum where the card fuses them: float32 rounding apart)."""
    coef = _erf_poly()
    t = np.minimum(np.abs(x), np.float32(4.0)).astype(np.float32)
    p = np.full_like(t, coef[7])
    for c in coef[6::-1]:
        p = p * t + c
    return np.copysign(np.float32(1.0) - np.exp2(p * t).astype(np.float32), x)


def test_erf_polynomial_of_the_kernel_is_erf_to_float32_rounding():
    x = np.linspace(-8.0, 8.0, 1_600_001).astype(np.float32)
    ref = np.vectorize(math.erf)(x[::16].astype(np.float64))
    assert np.abs(_erf7(x[::16]) - ref).max() <= 1.5e-7
    # GELU on it against the plain version's exact-erf GELU: the error of erf times |x| / 2
    y = np.linspace(-12.0, 12.0, 200_001).astype(np.float32)
    half = np.float32(0.5) * y
    gelu7 = half * _erf7(y * np.float32(0.70710678118654752440)) + half
    exact = gelu_exact(torch.from_numpy(y).double()).numpy()
    assert np.abs(gelu7 - exact).max() <= 1e-6
    assert (np.abs(gelu7 - exact) <= 1.5e-7 * np.maximum(1.0, np.abs(y))).all()


def test_wgmma_chain_plain_version():
    rng = np.random.default_rng(5)
    x, w0, w1 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
                 for s in ((64, 64), (256, 64), (256, 256)))
    out0, out1 = rot_ops.wgmma_chain(x, w0, w1)         # CPU tensors: the plain version
    ref0 = x.double() @ w0.double().T
    ref1 = ref0.float().bfloat16().double() @ w1.double().T
    assert out0.shape == out1.shape == (64, 256) and out0.dtype == out1.dtype == F32
    np.testing.assert_allclose(out0.numpy(), ref0.numpy(), atol=1e-5 * ref0.abs().max().item())
    np.testing.assert_allclose(out1.numpy(), ref1.numpy(), atol=1e-3 * ref1.abs().max().item())


# ---- csrc/wgmma_tile.cuh in numpy ---------------------------------------------------------

def _stage_weight(w):
    """`stage_weight`: (n_rows, K) bf16-sized elements -> bytes of K / 64
    swizzled panels, as uint16 element slots (2 bytes each)."""
    n_rows, k = w.shape
    out = np.full(n_rows * k, -1, dtype=np.int64)
    for n in range(n_rows):
        for c in range(k // 8):
            panel, chunk = c // 8, c % 8
            byte = panel * n_rows * 128 + n * 128 + ((chunk ^ (n & 7)) << 4)
            out[byte // 2:byte // 2 + 8] = w[n, c * 8:c * 8 + 8]
    return out


def _read_panel(staged, n_rows, n, kk):
    """What the tensor core reads for weight element (n, kk) of a staged
    weight: panel kk / 64, row n, the 128-byte swizzle undone."""
    panel, col = kk // 64, kk % 64
    byte = panel * n_rows * 128 + n * 128 + (((col // 8) ^ (n & 7)) << 4) + (col % 8) * 2
    return staged[byte // 2]


@pytest.mark.parametrize("n_rows,k", [(256, 64), (256, 256)])
def test_weight_panels_round_trip(n_rows, k):
    w = np.arange(n_rows * k, dtype=np.int64).reshape(n_rows, k)
    staged = _stage_weight(w)
    assert sorted(staged.tolist()) == list(range(n_rows * k))        # a permutation
    rng = np.random.default_rng(0)
    for n, kk in zip(rng.integers(0, n_rows, 500), rng.integers(0, k, 500)):
        assert _read_panel(staged, n_rows, int(n), int(kk)) == w[n, kk]
    # every panel, and every 128-row half of it, starts on a 1024-byte boundary
    assert (n_rows * 128) % 1024 == 0 and (128 * 128) % 1024 == 0


def test_accumulator_fragment_is_the_next_a_fragment():
    """Thread (warp w, g, t) holds accumulator d[4 j + e] at row 16 w + g +
    8 (e / 2), column 8 j + 2 t + e % 2; packed as the kernel packs it
    (k-step s: n-tiles 2 s and 2 s + 1) every thread ends up with exactly the
    elements the A fragment of that k-step asks of it."""
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for s in range(8):                       # k-steps of one 128-column half
                acc = {(j, e): (16 * w + g + 8 * (e // 2), 8 * j + 2 * t + e % 2)
                       for j in (2 * s, 2 * s + 1) for e in range(4)}
                packed = [(acc[2 * s, 0], acc[2 * s, 1]), (acc[2 * s, 2], acc[2 * s, 3]),
                          (acc[2 * s + 1, 0], acc[2 * s + 1, 1]),
                          (acc[2 * s + 1, 2], acc[2 * s + 1, 3])]
                want = [((16 * w + g + 8 * (i % 2), 16 * s + 8 * (i // 2) + 2 * t),
                         (16 * w + g + 8 * (i % 2), 16 * s + 8 * (i // 2) + 2 * t + 1))
                        for i in range(4)]
                assert packed == want
