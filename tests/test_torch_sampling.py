"""Port sampler (`catre_tpu_torch/ops/sampling.py`) vs the JAX package's
(`catre_tpu/ops/sampling.py`): the same numpy inputs and the same
`jax.random` priority fields, drawn with the key splits the JAX functions
make, go to both. Indices and n_inside must be equal and points bit-equal,
the tie cases included."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catre_tpu.geom import backproject as j_backproject
from catre_tpu.ops import sampling as js
from catre_tpu_torch.entry import example_frames
from catre_tpu_torch.geom.transforms import backproject as t_backproject
from catre_tpu_torch.ops import sampling as ts

J = jnp.asarray


def T(a):
    """A torch copy of an array (JAX's are read-only)."""
    return torch.from_numpy(np.array(a))


def _equal(ref, port):
    """Every output of the JAX function equals the port's, bit for bit."""
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        else:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _uniform_rows(key, m, n):
    """The (m, n) field that a per-image JAX function draws from `key`."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jax.random.split(key, m)))


def _uniform(key, n):
    return np.asarray(jax.random.uniform(key, (n,)))


# ---- exact arithmetic

def test_norm3_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(200_000, 3)) * rng.uniform(1e-3, 5, size=(200_000, 1))).astype(np.float32)
    ref = np.asarray(jnp.linalg.norm(J(v), axis=-1))
    np.testing.assert_array_equal(ref.view(np.int32), ts.norm3(T(v)).numpy().view(np.int32))


def test_ball_radius_is_bit_equal_to_jax():
    """ratio * ||R @ s|| as the JAX sampler computes it (vmapped, jitted) on
    10k random (R, s)."""
    rng = np.random.default_rng(1)
    n = 10_000
    pose = rng.normal(size=(n, 3, 4)).astype(np.float32)
    scale = rng.uniform(0.02, 0.5, size=(n, 3)).astype(np.float32)
    for ratio in (0.6, 1.0):
        ref = np.asarray(jax.jit(jax.vmap(
            lambda p, s: ratio * jnp.linalg.norm(p[:, :3] @ s)))(J(pose), J(scale)))
        port = ts.ball_radius(T(pose), T(scale), ratio).numpy()
        np.testing.assert_array_equal(ref.view(np.int32), port.view(np.int32))


def _f32_nearest(x: Fraction) -> np.float32:
    """The f32 nearest to the exact rational x, ties to the even mantissa."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def test_exact_helpers_round_correctly():
    """fma32 and sqrt32 against exact rational arithmetic, with a product on
    an f32 midpoint that a float64 sum rounded twice would get wrong."""
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=3000).astype(np.float32) for _ in range(3))
    one = np.float32(1 + 2.0 ** -12)          # one * one sits on an f32 midpoint
    a, b, c = (np.append(v, w) for v, w in ((a, one), (b, one), (c, np.float32(2.0 ** -60))))
    got = ts.fma32(T(a), T(b), T(c)).numpy()
    want = [_f32_nearest(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    assert got[-1] != np.float32(np.float64(one) * np.float64(one) + 2.0 ** -60)
    x = np.abs(a)
    np.testing.assert_array_equal(ts.sqrt32(T(x)).numpy(), np.sqrt(x))


# ---- one candidate field

def _field(n_in, n_out, rng, center):
    inside = (rng.normal(size=(n_in, 3)) * 0.02 + center).astype(np.float32)
    outside = (rng.normal(size=(n_out, 3)) * 0.02 + center + 5.0).astype(np.float32)
    return np.concatenate([inside, outside])


CASES = {
    # name: (n inside, n outside, radius, num_points, valid rows)
    "full_ball": (300, 200, 0.2, 128, None),
    "scarce_cycles": (20, 100, 0.2, 64, None),
    "all_invalid": (30, 20, 0.2, 16, "none"),
    "far_valid_fallback": (0, 50, 0.1, 16, "first30"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ties", [False, True])
def test_ball_crop_indices_match_jax(case, ties):
    n_in, n_out, radius, npts, rows = CASES[case]
    rng = np.random.default_rng(3)
    center = np.array([0.1, -0.05, 1.0], np.float32)
    pts = _field(n_in, n_out, rng, center)
    n = len(pts)
    valid = np.ones(n, bool)
    if rows == "none":
        valid[:] = False
    elif rows == "first30":
        valid[30:] = False
    key = jax.random.PRNGKey(4)
    pri = _uniform(key, n)
    if ties:   # the tie rule decides: 64 levels over n candidates
        pri = np.floor(pri * 64) / 64
        ref = js.ball_inside_mask(J(pts), J(valid), J(center), jnp.float32(radius))
        p = jnp.where(ref[0], J(pri), js.BIG)
        idx = jax.lax.top_k(-p, npts)[1].astype(jnp.int32)
        ref = (js.cycle_indices_mxu(idx, ref[1], npts, n), ref[1])
    else:
        ref = js.ball_crop_indices(key, J(pts), J(valid), J(center), jnp.float32(radius), npts)
    port = ts.ball_crop_indices(T(pts), T(valid), T(center), torch.tensor(radius), npts,
                                priorities=T(pri))
    _equal(ref, port)
    if rows == "none":
        assert int(port[1]) == 0 and port[0].eq(0).all()      # index 0 repeated


def test_radius_growth_matches_jax():
    rng = np.random.default_rng(5)
    near = (rng.normal(size=(5, 3)) * 0.005).astype(np.float32)
    ring = np.zeros((30, 3), np.float32)
    ring[:, 0] = 0.058        # inside 0.05 * 1.1^2, outside 0.055
    pts = np.concatenate([near, ring])
    valid, center = np.ones(35, bool), np.zeros(3, np.float32)
    key = jax.random.PRNGKey(2)
    ref = js.ball_crop_indices(key, J(pts), J(valid), J(center), jnp.float32(0.01), 16)
    port = ts.ball_crop_indices(T(pts), T(valid), T(center), torch.tensor(0.01), 16,
                                priorities=T(_uniform(key, 35)))
    _equal(ref, port)
    assert int(port[1]) == 35


def test_crop_ball_from_cloud_batched_rows():
    """Leading batch dims: each row of a (2, 3) batch equals its own JAX call."""
    rng = np.random.default_rng(6)
    n, npts = 400, 64
    pts = (rng.normal(size=(2, 3, n, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)
    valid = rng.random((2, 3, n)) < 0.9
    pose = np.tile(np.eye(3, 4, dtype=np.float32), (2, 3, 1, 1))
    pose[..., :, 3] = (rng.normal(size=(2, 3, 3)) * 0.05 + [0, 0, 1]).astype(np.float32)
    scale = rng.uniform(0.05, 0.2, size=(2, 3, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), 6)
    pri = np.stack([_uniform(k, n) for k in keys]).reshape(2, 3, n)
    port = ts.crop_ball_from_cloud(T(pts), T(valid), T(pose), T(scale), 0.6, npts,
                                   priorities=T(pri))
    for i in range(2):
        for j in range(3):
            ref = js.crop_ball_from_cloud(keys[3 * i + j], J(pts[i, j]), J(valid[i, j]),
                                          J(pose[i, j]), J(scale[i, j]), 0.6, npts)
            _equal(ref, [o[i, j] for o in port])


# ---- image-level crops

def _frame(h=96, w=128, m=3, seed=3):
    """test_sampling.py's frame: an interior blob, one against the top-left
    border, an empty slot."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((h, w), np.uint16)
    masks = np.zeros((m, h, w), bool)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (m, 1, 1))
    K = np.array([[600.0, 0, 64.0], [0, 600.0, 48.0], [0, 0, 1]], np.float32)
    for i, (r0, r1, c0, c1) in enumerate([(40, 64, 60, 90), (0, 20, 0, 25)]):
        depth[r0:r1, c0:c1] = rng.integers(800, 1200, (r1 - r0, c1 - c0))
        masks[i, r0:r1, c0:c1] = rng.random((r1 - r0, c1 - c0)) < 0.8
        rc, cc = (r0 + r1) // 2, (c0 + c1) // 2
        z = depth[rc, cc] / 1000.0
        poses[i, :, 3] = [(cc - K[0, 2]) / K[0, 0] * z, (rc - K[1, 2]) / K[1, 1] * z, max(z, 0.9)]
    return depth, masks, poses, np.full((m, 3), 0.25, np.float32), K


def _pack(masks, dtype):
    word = np.zeros(masks.shape[1:], dtype)
    for i in range(masks.shape[0]):
        word |= masks[i].astype(dtype) << dtype(i)
    return word


def _bbox(masks):
    m, h, w = masks.shape
    out = np.empty((m, 4), np.int32)
    out[:] = (h, -1, w, -1)
    for i in range(m):
        rows, cols = masks[i].any(axis=1), masks[i].any(axis=0)
        if rows.any():
            rnz, cnz = np.flatnonzero(rows), np.flatnonzero(cols)
            out[i] = (rnz[0], rnz[-1], cnz[0], cnz[-1])
    return out


@pytest.mark.parametrize("ratio", [1.0, 0.6])
def test_batch_ball_crop_full_frame_matches_jax(ratio):
    depth, masks, poses, scales, K = _frame()
    key = jax.random.PRNGKey(7)
    cloud = j_backproject(J(depth.astype(np.float32) / 1000.0), J(K))
    t_cloud = t_backproject(ts.depth_metres(T(depth)), T(K))
    np.testing.assert_array_equal(np.asarray(cloud), t_cloud.numpy())
    ref = js.batch_ball_crop(key, cloud, J(masks), J(poses), J(scales), ratio=ratio,
                             num_points=256)
    port = ts.batch_ball_crop(t_cloud, T(masks), T(poses), T(scales), ratio, 256,
                              priorities=T(_uniform_rows(key, 3, depth.size)))
    _equal(ref, port)


@pytest.mark.parametrize("ws", [48, 64])
def test_window_forms_match_jax(ws):
    """The materialized windowed crop, the fused from-depth crop (u8 word,
    bool stack, f32 depth) and candidates + select all equal JAX's."""
    depth, masks, poses, scales, K = _frame()
    h, w = depth.shape
    key = jax.random.PRNGKey(7)
    pri = T(_uniform_rows(key, 3, ws * ws))
    cloud = j_backproject(J(depth.astype(np.float32) / 1000.0), J(K))
    ref = js.batch_ball_crop(key, cloud, J(masks), J(poses), J(scales), ratio=1.0,
                             num_points=256, window_size=ws)
    _equal(ref, ts.batch_ball_crop(T(np.asarray(cloud)), T(masks), T(poses), T(scales), 1.0, 256,
                                   window_size=ws, priorities=pri))
    bbox = _bbox(masks)
    for d in (T(depth), T(depth.view(np.int16)), T(depth.astype(np.float32) / 1000.0)):
        for packed in (T(_pack(masks, np.uint8)), T(masks)):
            args = (d, T(K), packed, T(bbox), T(poses), T(scales))
            _equal(ref, ts.batch_ball_crop_from_depth(*args, 1.0, 256, ws, priorities=pri))
            cand = ts.batch_ball_crop_candidates(*args, 1.0, ws)
            _equal(ref, ts.batch_select_from_candidates(*cand, 256, w, ws, priorities=pri))
    jcand = js.batch_ball_crop_candidates(J(depth), J(K), J(_pack(masks, np.uint8)), J(bbox),
                                          J(poses), J(scales), ratio=1.0, window_size=ws)
    _equal(jcand, ts.batch_ball_crop_candidates(T(depth), T(K), T(_pack(masks, np.uint8)),
                                                T(bbox), T(poses), T(scales), 1.0, ws))


@pytest.mark.parametrize("where", ["top_left", "bottom_right", "top_right", "bottom_left"])
def test_windows_at_the_frame_edges(where):
    """Masks against each corner: the origin clamps, and every form still
    equals JAX."""
    h, w, ws, npts = 80, 112, 40, 128
    rng = np.random.default_rng(9)
    r = slice(0, 18) if "top" in where else slice(h - 18, h)
    c = slice(0, 22) if "left" in where else slice(w - 22, w)
    depth = np.zeros((h, w), np.uint16)
    depth[r, c] = rng.integers(900, 1100, (18, 22))
    masks = np.zeros((2, h, w), bool)
    masks[0, r, c] = rng.random((18, 22)) < 0.9
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    rc, cc = (r.start + r.stop) // 2, (c.start + c.stop) // 2
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    poses[0, :, 3] = [(cc - w / 2) / 500.0, (rc - h / 2) / 500.0, 1.0]
    scales = np.full((2, 3), 0.2, np.float32)
    key = jax.random.PRNGKey(11)
    bbox = _bbox(masks)
    ref = js.batch_ball_crop_from_depth(key, J(depth), J(K), J(_pack(masks, np.uint8)), J(bbox),
                                        J(poses), J(scales), ratio=0.6, num_points=npts,
                                        window_size=ws)
    port = ts.batch_ball_crop_from_depth(T(depth), T(K), T(_pack(masks, np.uint8)), T(bbox),
                                         T(poses), T(scales), 0.6, npts, ws,
                                         priorities=T(_uniform_rows(key, 2, ws * ws)))
    _equal(ref, port)
    assert int(port[2][0]) > 0 and int(port[2][1]) == 0


def test_window_between_image_dims():
    """h < window < w: the slice clamps per dimension; the windowed forms
    equal JAX's and hold the full frame's candidate set."""
    h, w, npts, ws = 40, 100, 1024, 64
    depth = np.zeros((h, w), np.uint16)
    depth[8:36, 30:70] = 1000
    masks = np.zeros((1, h, w), bool)
    masks[0, 10:34, 35:65] = True
    K = np.array([[500.0, 0, 50.0], [0, 500.0, 20.0], [0, 0, 1]], np.float32)
    pose = np.eye(3, 4, dtype=np.float32)[None].copy()
    pose[0, :, 3] = [0.0, 0.0, 1.0]
    scale = np.full((1, 3), 0.3, np.float32)
    key = jax.random.PRNGKey(3)
    cloud = j_backproject(J(depth.astype(np.float32) / 1000.0), J(K))
    t_cloud = T(np.asarray(cloud))
    full = ts.batch_ball_crop(t_cloud, T(masks), T(pose), T(scale), 3.0, npts,
                              priorities=T(_uniform_rows(key, 1, h * w)))
    _equal(js.batch_ball_crop(key, cloud, J(masks), J(pose), J(scale), ratio=3.0,
                              num_points=npts), full)
    pri = T(_uniform_rows(key, 1, h * ws))
    ref = js.batch_ball_crop(key, cloud, J(masks), J(pose), J(scale), ratio=3.0, num_points=npts,
                             window_size=ws)
    win = ts.batch_ball_crop(t_cloud, T(masks), T(pose), T(scale), 3.0, npts, window_size=ws,
                             priorities=pri)
    bbox = np.array([[10, 33, 35, 64]], np.int32)
    fused = ts.batch_ball_crop_from_depth(T(depth), T(K), T(masks), T(bbox), T(pose), T(scale),
                                          3.0, npts, ws, priorities=pri)
    _equal(ref, win)
    _equal(ref, fused)
    assert int(win[2][0]) == 24 * 30
    assert set(full[1][0].tolist()) == set(win[1][0].tolist())


@pytest.mark.parametrize("dtype,m", [(np.uint8, 8), (np.uint16, 16), (np.uint32, 32),
                                     (bool, 33)])
def test_mask_words_and_the_bool_stack(dtype, m):
    """Bits 7, 15 and 31 of the widest instance of each word, and the
    unpacked stack for M > 32: the same candidates as JAX."""
    h, w, ws, npts = 48, 64, 32, 64
    rng = np.random.default_rng(12)
    depth = rng.integers(700, 1300, (h, w)).astype(np.uint16)
    masks = np.zeros((m, h, w), bool)
    for i in range(m):
        r0, c0 = rng.integers(0, h - 12), rng.integers(0, w - 12)
        masks[i, r0:r0 + 12, c0:c0 + 12] = rng.random((12, 12)) < 0.8
    K = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2], [0, 0, 1]], np.float32)
    bbox = _bbox(masks)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (m, 1, 1))
    for i in range(m):
        rc, cc = (bbox[i, 0] + bbox[i, 1]) / 2, (bbox[i, 2] + bbox[i, 3]) / 2
        poses[i, :, 3] = [(cc - w / 2) / 400.0, (rc - h / 2) / 400.0, 1.0]
    scales = np.full((m, 3), 0.05, np.float32)
    packed = masks if dtype is bool else _pack(masks, dtype)
    key = jax.random.PRNGKey(13)
    ref = js.batch_ball_crop_from_depth(key, J(depth), J(K), J(packed), J(bbox), J(poses),
                                        J(scales), ratio=0.6, num_points=npts, window_size=ws)
    pri = T(_uniform_rows(key, m, ws * ws))
    port = ts.batch_ball_crop_from_depth(T(depth), T(K), T(packed), T(bbox), T(poses), T(scales),
                                         0.6, npts, ws, priorities=pri)
    _equal(ref, port)
    assert int(port[2][m - 1]) > 0
    # the materialized form unpacks the same word
    assert torch.equal(ts.unpack_masks(T(packed)[None], m)[0], T(masks))


def test_fps_sample_matches_jax():
    depth, masks, poses, scales, K = _frame()
    key = jax.random.PRNGKey(5)
    cloud = j_backproject(J(depth.astype(np.float32) / 1000.0), J(K))
    ref = js.batch_ball_crop(key, cloud, J(masks), J(poses), J(scales), ratio=0.6, num_points=48,
                             fps_sample=True, window_size=48)    # FPS ignores the window
    port = ts.batch_ball_crop(T(np.asarray(cloud)), T(masks), T(poses), T(scales), 0.6, 48,
                              fps_sample=True, window_size=48,
                              priorities=T(_uniform_rows(key, 3, depth.size)))
    _equal(ref, port)


@pytest.mark.parametrize("with_valid", [False, True])
def test_farthest_point_indices_match_jax(with_valid):
    rng = np.random.default_rng(14)
    clusters = [rng.normal(size=(50, 3)) * 0.01 + c
                for c in ([0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1])]
    pts = np.concatenate(clusters).astype(np.float32)
    valid = rng.random(200) < 0.7 if with_valid else None
    ref = js.farthest_point_indices(J(pts), 16, valid=None if valid is None else J(valid))
    port = ts.farthest_point_indices(T(pts), 16, valid=None if valid is None else T(valid))
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())


@pytest.mark.parametrize("n_valid", [None, 10, 0, 100])
def test_random_sample_indices_match_jax(n_valid):
    key = jax.random.PRNGKey(5)
    ref = js.random_sample_indices(key, 100, 50,
                                   n_valid=None if n_valid is None else jnp.int32(n_valid))
    port = ts.random_sample_indices(100, 50, n_valid=n_valid, priorities=T(_uniform(key, 100)))
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())


def test_group_of_frames_matches_per_image_jax():
    """A (G, M) group in one call equals JAX image by image, on the frames
    the chip check uses (holes, occlusion, padded slots) at a small size."""
    f = example_frames(3, 120, 160, m=4, seed=1, objs=(1, 4), size_px=(16, 60))
    ws, npts = 64, 64
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    pri = np.stack([_uniform_rows(k, 4, ws * ws) for k in keys])
    port = ts.batch_ball_crop_from_depth(T(f["depth"]), T(f["K"]), T(f["packed"]),
                                         T(f["mask_bbox"]), T(f["poses"]), T(f["scales"]), 0.6,
                                         npts, ws, priorities=T(pri))
    for i in range(3):
        ref = js.batch_ball_crop_from_depth(
            keys[i], J(f["depth"][i]), J(f["K"][i]), J(f["packed"][i]), J(f["mask_bbox"][i]),
            J(f["poses"][i]), J(f["scales"][i]), ratio=0.6, num_points=npts, window_size=ws)
        _equal(ref, [o[i] for o in port])
    assert (port[2] == 0).any() and (port[2] > npts).any()


def test_generator_selects_inside_candidates_uniformly():
    """The port's own draws (torch.Generator): inside candidates only, no
    repeat while enough are inside, and every inside candidate equally
    likely (chi-square, 99 degrees of freedom, p = 0.001 bound 148.2)."""
    gen = torch.Generator().manual_seed(0)
    n, n_in, npts, trials = 300, 100, 20, 2000
    inside = torch.zeros(trials, n, dtype=torch.bool)
    pos = torch.randperm(n, generator=torch.Generator().manual_seed(1))[:n_in]
    inside[:, pos] = True
    n_inside = inside.sum(-1).int()
    idx = ts.select_inside(inside, n_inside, npts, generator=gen)
    assert inside.gather(1, idx).all()
    assert all(len(set(row.tolist())) == npts for row in idx)
    counts = torch.bincount(idx.flatten(), minlength=n)[pos].double()
    expected = trials * npts / n_in
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 148.2, chi2
    # scarce rows cycle through every inside candidate
    few = inside[:4].clone()
    few[:, pos[10:]] = False
    idx = ts.select_inside(few, few.sum(-1).int(), npts, generator=gen)
    for row in idx:
        assert set(row.tolist()) == set(pos[:10].tolist())
    with pytest.raises(ValueError, match="Generator"):
        ts.select_inside(few, few.sum(-1).int(), npts)
