"""The port's NOCS scorer (`catre_tpu_torch/eval/nocs_eval.py`) and keypoint
selection (`catre_tpu_torch/data/kps.py`) against the JAX package's on the
CPU. The scorer is a numpy copy: every case is bit-equal (same dtype, same
bits, NaN where JAX has NaN), on seeded random boxes that cover the cases of
`tests/test_eval.py` (which holds the JAX scorer against the reference's)."""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catre_tpu.data import kps as jkps
from catre_tpu.eval import nocs_eval as jne
from catre_tpu_torch.data import kps as tkps
from catre_tpu_torch.eval import nocs_eval as tne

LINEMOD_SYNSET = ["BG", "phone", "eggbox", "glue", "ape", "bottle", "mug"]


def _rand_rot(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diagonal(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _rand_rt(rng):
    RT = np.eye(4)
    RT[:3, :3] = _rand_rot(rng)
    RT[:3, 3] = rng.normal(size=3) * 0.3 + [0, 0, 1]
    return RT


def _rand_result(rng, n_gt=4, n_pred=5):
    """One image's gt and predictions; the first predictions lie near gt."""
    gt_class_ids = rng.integers(1, 7, size=n_gt)
    pred_class_ids = rng.integers(1, 7, size=n_pred)
    gt_RTs = np.stack([_rand_rt(rng) for _ in range(n_gt)])
    pred_RTs = np.stack([_rand_rt(rng) for _ in range(n_pred)])
    for i in range(min(n_gt, n_pred) - 1):
        pred_RTs[i] = gt_RTs[i].copy()
        pred_RTs[i][:3, 3] += rng.normal(size=3) * 0.01
        pred_class_ids[i] = gt_class_ids[i]
    gt_scales = rng.uniform(0.1, 0.4, size=(n_gt, 3))
    pred_scales = gt_scales[:n_pred].copy() if n_pred <= n_gt else np.concatenate(
        [gt_scales, rng.uniform(0.1, 0.4, size=(n_pred - n_gt, 3))])
    pred_scales = pred_scales * rng.uniform(0.9, 1.1, size=pred_scales.shape)
    return {
        "gt_class_ids": gt_class_ids.astype(np.int32),
        "gt_RTs": gt_RTs,
        "gt_scales": gt_scales,
        "gt_handle_visibility": rng.integers(0, 2, size=n_gt),
        "pred_bboxes": rng.uniform(1, 400, size=(n_pred, 4)),
        "pred_class_ids": pred_class_ids.astype(np.int32),
        "pred_scales": pred_scales,
        "pred_scores": rng.uniform(0.3, 1.0, size=n_pred),
        "pred_RTs": pred_RTs,
    }


def _same(a, b, what=""):
    """Bit-equal: scalars, arrays (dtype, shape, bits, NaN where NaN) and
    nested tuples / lists of them."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape, (what, x.dtype, y.dtype, x.shape, y.shape)
    assert type(a) is type(b), (what, type(a), type(b))
    assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), what


# ---- cases: name -> f(module, rng) -> result; each runs on both packages with one seed

def _iou(ne, rng):
    out = []
    for _ in range(10):
        RT1, RT2 = _rand_rt(rng), _rand_rt(rng)
        s1, s2 = rng.uniform(0.1, 0.4, size=3), rng.uniform(0.1, 0.4, size=3)
        for cname, hv in (("bottle", 1), ("mug", 0), ("mug", 1), ("camera", 1), ("bowl", 0)):
            out.append(ne.compute_3d_iou_new(RT1, RT2, s1, s2, hv, cname, cname))
    out.append(ne.get_3d_bbox(rng.uniform(0.1, 0.4, size=3), 0.1))
    return out


def _rt_error(ne, rng):
    out = []
    for _ in range(10):
        RT1, RT2 = _rand_rt(rng), _rand_rt(rng)
        for synset in (ne.SYNSET_NAMES, LINEMOD_SYNSET):
            for cls_id in range(1, 7):
                for hv in (0, 1):
                    out.append(ne.compute_RT_degree_cm_symmetry(RT1, RT2, cls_id, hv, synset))
    return out


def _rt_180_edge(ne, rng):
    """Exact y-flips: the flip trace lands epsilon outside [-1, 1]."""
    y180 = np.diag([-1.0, 1.0, -1.0])
    out = []
    for _ in range(30):
        gt = _rand_rt(rng)
        pred = gt.copy()
        pred[:3, :3] = gt[:3, :3] @ y180
        with np.errstate(invalid="ignore"):
            out.append(ne.pairwise_degree_cm(pred[None], gt[None], [1], [1], LINEMOD_SYNSET))
            out.append(ne.compute_RT_degree_cm_symmetry(pred, gt, 1, 1, LINEMOD_SYNSET))
    return out


def _sym_classes(ne, rng):
    out = []
    for _ in range(5):
        pred_RTs = np.stack([_rand_rt(rng) for _ in range(4)])
        gt_RTs = np.stack([_rand_rt(rng) for _ in range(6)])
        gt_cls, gt_hv = rng.integers(1, 7, size=6), rng.integers(0, 2, size=6)
        out.append(ne.pairwise_degree_cm(pred_RTs, gt_RTs, gt_cls, gt_hv, LINEMOD_SYNSET))
    return out


def _ap(ne, rng):
    out = []
    for _ in range(10):
        pred_match = rng.choice([-1, 0, 1, 2], size=20).astype(float)
        scores = rng.uniform(size=20)
        gt_match = rng.choice([-1, 0, 1], size=8).astype(float)
        out.append(ne.compute_ap_from_matches_scores(pred_match, scores, gt_match))
    return out


def _pairwise(ne, rng):
    out = []
    for _ in range(5):
        P, G = 6, 4
        pred_RTs = np.stack([_rand_rt(rng) for _ in range(P)])
        gt_RTs = np.stack([_rand_rt(rng) for _ in range(G)])
        pred_scales, gt_scales = rng.uniform(0.1, 0.4, (P, 3)), rng.uniform(0.1, 0.4, (G, 3))
        pred_cls, gt_cls = rng.integers(1, 7, size=P), rng.integers(1, 7, size=G)
        gt_hv = rng.integers(0, 2, size=G)
        sym = ne._sym_pair_mask(pred_cls, gt_cls, gt_hv, ne.SYNSET_NAMES)
        ious = ne.pairwise_3d_ious(pred_RTs, pred_scales, gt_RTs, gt_scales, sym)
        scalar = [[ne.compute_3d_iou_new(pred_RTs[i], gt_RTs[j], pred_scales[i], gt_scales[j],
                                         gt_hv[j], ne.SYNSET_NAMES[pred_cls[i]],
                                         ne.SYNSET_NAMES[gt_cls[j]]) for j in range(G)]
                  for i in range(P)]
        np.testing.assert_allclose(ious, scalar, atol=1e-9)      # vectorised = per pair
        deg = ne.pairwise_degree_cm(pred_RTs, gt_RTs, gt_cls, gt_hv, ne.SYNSET_NAMES)
        for i in range(P):
            for j in range(G):
                np.testing.assert_allclose(deg[i, j], ne.compute_RT_degree_cm_symmetry(
                    pred_RTs[i], gt_RTs[j], gt_cls[j], gt_hv[j], ne.SYNSET_NAMES), atol=1e-9)
        out += [sym, ious, deg]
    return out


def _matches(ne, rng):
    r = _rand_result(rng, 5, 6)
    return list(ne.compute_3d_matches(
        r["gt_class_ids"], r["gt_RTs"], r["gt_scales"], r["gt_handle_visibility"],
        ne.SYNSET_NAMES, r["pred_bboxes"], r["pred_class_ids"], r["pred_scores"], r["pred_RTs"],
        r["pred_scales"], [0.1, 0.25, 0.5, 0.75]))


def _full_map(ne, rng):
    results = [_rand_result(rng, 4, 5), _rand_result(rng, 3, 3), _rand_result(rng, 5, 2)]
    out = []
    for kw in (dict(degree_thresholds=[5, 10], shift_thresholds=[2, 5],
                    iou_3d_thresholds=[0.10, 0.25, 0.50, 0.75]),
               dict(degree_thresholds=[5, 10], shift_thresholds=[2, 5, 10],
                    iou_3d_thresholds=[0.10, 0.25, 0.50, 0.75], use_matches_for_pose=False)):
        out.append(ne.compute_independent_mAP([dict(r) for r in results], ne.SYNSET_NAMES,
                                              **kw))
    return out


def _combination(ne, rng):
    results = [_rand_result(rng, int(rng.integers(1, 5)), int(rng.integers(1, 6)))
               for _ in range(12)]
    return ne.compute_combination_mAP(results, ne.SYNSET_NAMES, degree_thresholds=[5, 10, 20],
                                      shift_thresholds=[0.05, 0.1, 0.2],
                                      iou_3d_thresholds=[0.25, 0.5, 0.75])


CASES = {"iou": _iou, "rt_error": _rt_error, "rt_180_edge": _rt_180_edge,
         "sym_classes": _sym_classes, "ap": _ap, "pairwise_vs_scalar": _pairwise,
         "matches": _matches, "full_map": _full_map, "combination_map": _combination}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_nocs_eval_is_bit_equal_to_jax(case, seed):
    ours = CASES[case](tne, np.random.default_rng(seed))
    ref = CASES[case](jne, np.random.default_rng(seed))
    _same(ours, ref, case)


def test_rt_180_edge_takes_the_nan_branch():
    """The crafted flips reach the branch where the second arccos is NaN
    (Python's min keeps the first; a NaN first propagates,
    `test_utils.py:676-679`), and there the port is JAX's bit for bit."""
    y180 = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(3)
    n_nan = 0
    for _ in range(50):
        gt = _rand_rt(rng)
        pred = gt.copy()
        pred[:3, :3] = gt[:3, :3] @ y180
        R1 = pred[:3, :3] / np.cbrt(np.linalg.det(pred[:3, :3]))
        R2 = gt[:3, :3] / np.cbrt(np.linalg.det(gt[:3, :3]))
        with np.errstate(invalid="ignore"):
            n_nan += int(np.isnan(np.arccos((np.einsum("ij,jk,ik->", R1, y180, R2) - 1) / 2)))
            ours = tne.pairwise_degree_cm(pred[None], gt[None], [1], [1], LINEMOD_SYNSET)
        _same(ours, jne.pairwise_degree_cm(pred[None], gt[None], [1], [1], LINEMOD_SYNSET))
    assert n_nan > 0


@pytest.mark.parametrize("combination", [False, True])
def test_standalone_scorer_cli_matches_jax(tmp_path, capsys, combination):
    """`python -m catre_tpu_torch.eval.nocs_eval results.pkl` prints what the
    JAX package's scorer prints and returns its tables."""
    rng = np.random.default_rng(4)
    results = {f"scene/{i:04d}": _rand_result(rng, 3, 3) for i in range(6)}
    path = tmp_path / "results.pkl"
    with open(path, "wb") as f:
        pickle.dump(results, f)
    argv = [str(path)] + (["--combination"] if combination else [])
    assert tne._main(argv) == 0
    ours = capsys.readouterr().out
    assert jne._main(argv) == 0
    assert ours == capsys.readouterr().out
    assert ("IoU75, 5 degree" in ours) if combination else ("3D IoU at 75" in ours)
    _same(tne.evaluate(str(path), combination), jne.evaluate(str(path), combination))
    capsys.readouterr()


# ---- select_kps

@pytest.mark.parametrize("num_kps,with_neg", [(4, False), (7, True), (10, False)])
def test_keypoint_tables_match_jax(num_kps, with_neg):
    _same(tkps.normed_bbox_corners(), jkps.normed_bbox_corners())
    _same(tkps.normed_axis_points(num_kps, with_neg), jkps.normed_axis_points(num_kps, with_neg))


@pytest.mark.parametrize("array", ["numpy", "torch"])
@pytest.mark.parametrize("kps_type", ["mean_shape", "MEAN_SHAPE", "fps", "bbox", "axis"])
def test_select_kps_matches_jax(kps_type, array):
    """Numpy in -> numpy out, a tensor in -> a tensor out on its device; the
    values and dtype of JAX's (numpy in for numpy, jnp in for torch)."""
    rng = np.random.default_rng(5)
    b, k = 3, 10
    arrays = {"mean_points": rng.normal(size=(b, k, 3)).astype(np.float32),
              "scale_est": rng.uniform(0.1, 0.3, size=(b, 3)).astype(np.float32),
              "fps_points": rng.normal(size=(b, k, 3)).astype(np.float32)}
    if array == "numpy":
        ours = tkps.select_kps(kps_type, num_kps=k, **arrays)
        ref = jkps.select_kps(kps_type, num_kps=k, **arrays)
        assert isinstance(ours, np.ndarray) and isinstance(ref, np.ndarray)
        _same(np.asarray(ours), np.asarray(ref))
        return
    ours = tkps.select_kps(kps_type, num_kps=k, **{n: torch.from_numpy(a)
                                                   for n, a in arrays.items()})
    ref = np.asarray(jkps.select_kps(kps_type, num_kps=k, **{n: jnp.asarray(a)
                                                             for n, a in arrays.items()}))
    assert torch.is_tensor(ours) and ours.device.type == "cpu"
    _same(ours.numpy(), ref)


def test_select_kps_refuses_an_unknown_type():
    with pytest.raises(NotImplementedError, match="Unknown keypoints type"):
        tkps.select_kps("nocs", scale_est=np.ones((2, 3), np.float32))
