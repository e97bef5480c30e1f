"""The port's offline tools (`catre_tpu_torch/tools/`) against the JAX
package's (`catre_tpu/tools/`), after `tests/test_tools.py`.

- `umeyama_similarity` / `ransac_umeyama`: bit-equal to JAX's (the same
  draws from `default_rng(seed)`).
- `pnp_pose` (numpy EPnP): within 1e-3 of the ground truth (JAX's bound) and
  within 1e-5 of `cv2.solvePnP(SOLVEPNP_EPNP)` on noise-free points; its
  RANSAC recovers the pose with 25% outliers.
- `process_frame` / `merge_test_gts`: the labels of a frame written with
  OpenCV and of one written with `data/png.py` equal to JAX's (Umeyama fields
  within 1e-6, PnP within 1e-3, bit-equal in practice), the mug re-centring,
  the refusals; a mask PNG with alpha raises where OpenCV would convert it.
- `prepare_init_results`, `repro_diff`, `trainrun_report`, `fetch_assets`:
  the same files, output and exit codes.
- `fps_sample`: the same keypoints as JAX's from the same model points."""

import json
import os
import pickle

import numpy as np
import pytest

from catre_tpu.data import assets as jassets
from catre_tpu.data import meta as jmeta
from catre_tpu.tools import alignment as jalign
from catre_tpu.tools import fetch_assets as jfetch
from catre_tpu.tools import fps_sample as jfps
from catre_tpu.tools import pose_data as jpose
from catre_tpu.tools import prepare_init_results as jprep
from catre_tpu.tools import repro_diff as jrepro
from catre_tpu.tools import trainrun_report as jreport
from catre_tpu_torch import tools as ttools
from catre_tpu_torch.data import assets as tassets
from catre_tpu_torch.data import png
from catre_tpu_torch.tools import alignment as talign
from catre_tpu_torch.tools import fetch_assets as tfetch
from catre_tpu_torch.tools import fps_sample as tfps
from catre_tpu_torch.tools import pose_data as tpose
from catre_tpu_torch.tools import prepare_init_results as tprep
from catre_tpu_torch.tools import repro_diff as trepro
from catre_tpu_torch.tools import trainrun_report as treport

K_CMRA = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]], dtype=np.float64)
MODEL = "bottle_red_stanford_norm"


def _rand_rot(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diagonal(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _project(pts, R, t, K):
    uv = (pts @ R.T + t) @ K.T
    return uv[:, :2] / uv[:, 2:]


def test_exports():
    assert ttools.__all__ == ["pnp_pose", "ransac_umeyama", "umeyama_similarity"]
    assert ttools.pnp_pose is talign.pnp_pose


def _same_bits(ours, ref):
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_umeyama_and_ransac_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(200, 3))
    R, s_gt, t_gt = _rand_rot(rng), 0.8, rng.normal(size=3)
    tgt = s_gt * src @ R.T + t_gt
    tgt[:50] += rng.normal(size=(50, 3)) * 2.0 + 5.0   # 25% outliers
    _same_bits(talign.umeyama_similarity(src, tgt), jalign.umeyama_similarity(src, tgt))
    ours = talign.ransac_umeyama(src, tgt, seed=seed)
    _same_bits(ours, jalign.ransac_umeyama(src, tgt, seed=seed))
    assert ours[0] == pytest.approx(s_gt, rel=1e-3)
    np.testing.assert_allclose(ours[1], R, atol=1e-3)
    np.testing.assert_allclose(ours[2], t_gt, atol=1e-3)
    # unrelated points: whatever the draws give, the same
    noise = np.random.default_rng(9).normal(size=(40, 3)) * 10.0
    _same_bits(talign.ransac_umeyama(src[:40], noise, seed=seed),
               jalign.ransac_umeyama(src[:40], noise, seed=seed))


@pytest.mark.parametrize("seed", [13, 14, 15, 16])
def test_pnp_matches_truth_and_opencv(seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    R, t = _rand_rot(rng), np.array([0.05, -0.1, 1.2])
    pts3d = rng.normal(size=(60, 3)) * 0.2
    uv = _project(pts3d, R, t, K_CMRA)
    pose = talign.pnp_pose(pts3d, uv, K_CMRA, ransac=False)
    assert pose.dtype == np.float32 and pose.shape == (3, 4)
    np.testing.assert_allclose(pose[:, :3], R, atol=1e-3)
    np.testing.assert_allclose(pose[:, 3], t, atol=1e-3)
    _, rvec, tvec = cv2.solvePnP(pts3d.reshape(-1, 1, 3), uv.reshape(-1, 1, 2), K_CMRA,
                                 np.zeros(4), flags=cv2.SOLVEPNP_EPNP)
    np.testing.assert_allclose(pose[:, :3], cv2.Rodrigues(rvec)[0], atol=1e-5)
    np.testing.assert_allclose(pose[:, 3], tvec.ravel(), atol=1e-5)
    # the JAX tool (cv2) without RANSAC
    np.testing.assert_allclose(pose, jalign.pnp_pose(pts3d, uv, K_CMRA, ransac=False), atol=1e-5)


def test_ransac_pnp_with_outliers():
    rng = np.random.default_rng(21)
    R, t = _rand_rot(rng), np.array([-0.1, 0.05, 0.9])
    pts3d = rng.normal(size=(80, 3)) * 0.15
    uv = _project(pts3d, R, t, K_CMRA)
    uv[:20] += rng.normal(size=(20, 2)) * 40.0 + 15.0      # 25% outliers
    pose = talign.pnp_pose(pts3d, uv, K_CMRA, rng=np.random.default_rng(3))
    np.testing.assert_allclose(pose[:, :3], R, atol=1e-3)
    np.testing.assert_allclose(pose[:, 3], t, atol=1e-3)
    # the outliers pull a fit over every point away
    plain = talign.pnp_pose(pts3d, uv, K_CMRA, ransac=False)
    assert np.abs(plain[:, 3] - t).max() > 1e-2
    # the default generator is seeded: the same pose again
    assert np.array_equal(talign.pnp_pose(pts3d, uv, K_CMRA), talign.pnp_pose(pts3d, uv, K_CMRA))
    with pytest.raises(ValueError, match="at least 4"):
        talign.pnp_pose(pts3d[:3], uv[:3], K_CMRA)


def _write_frame(tmp_path, name, writer, s_gt=0.4, tilt=0.0, inst=7, mask_kind="grey"):
    """A NOCS-format frame (a plate at z = 1 m under identity rotation, tilted
    in depth by `tilt` per unit of x) written by `writer` ("cv2" or "png");
    -> (base, K, t_gt)."""
    K = jmeta.REAL_INTRINSICS
    h, w = jmeta.IM_HEIGHT, jmeta.IM_WIDTH
    depth = np.zeros((h, w), np.uint16)
    mask = np.zeros((h, w), np.uint8)
    coord = np.zeros((h, w, 3), np.uint8)
    cy, cx, half = 240, 320, 40
    ys, xs = np.mgrid[cy - half: cy + half, cx - half: cx + half]
    t_gt = np.array([(cx - K[0, 2]) / K[0, 0], (cy - K[1, 2]) / K[1, 1], 1.0])
    X = (xs - K[0, 2]) / K[0, 0]
    Y = (ys - K[1, 2]) / K[1, 1]
    Z = tilt * (X - t_gt[0])
    nocs = np.stack([(X - t_gt[0]) / s_gt, (Y - t_gt[1]) / s_gt, Z / s_gt], axis=2)
    rgb = np.clip((nocs + 0.5) * 255, 0, 255).astype(np.uint8)
    bgr = rgb[:, :, ::-1].copy()
    bgr[:, :, 0] = np.clip((1.0 - (nocs[:, :, 2] + 0.5)) * 255, 0, 255).astype(np.uint8)
    depth[ys, xs] = np.round((1.0 + Z) * 1000).astype(np.uint16)
    mask[ys, xs] = inst
    coord[ys, xs] = bgr
    base = str(tmp_path / name)
    if mask_kind == "bgr":
        mask = np.stack([np.zeros_like(mask), np.zeros_like(mask), mask], axis=2)
    if writer == "cv2":
        import cv2

        for suffix, img in (("depth", depth), ("mask", mask), ("coord", coord)):
            cv2.imwrite(f"{base}_{suffix}.png", img)
    else:
        for suffix, img in (("depth", depth), ("mask", mask), ("coord", coord)):
            png.write_png(f"{base}_{suffix}.png", img)
    with open(base + "_meta.txt", "w") as f:
        f.write(f"{inst} 1 {MODEL}\n3 2 bowl_tiny_norm\n")
    return base, K, t_gt


def _same_label(ours, ref, atol):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = ours[k], ref[k]
        if k in ("instance_ids", "class_ids", "model_list", "bboxes", "handle_visibility"):
            assert np.array_equal(np.asarray(a), np.asarray(b)), k
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                       atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("writer,tilt,mask_kind", [("cv2", 0.0, "grey"), ("png", 0.0, "bgr"),
                                                   ("png", 0.3, "grey")])
def test_process_frame_labels_match_jax(tmp_path, writer, tilt, mask_kind):
    if writer == "cv2" or mask_kind == "bgr":
        pytest.importorskip("cv2")
    base, K, t_gt = _write_frame(tmp_path, "0000", writer, tilt=tilt, mask_kind=mask_kind)
    mug_meta = {MODEL: (np.array([0.01, -0.02, 0.03]), 1.2)}
    for method, atol in (("umeyama", 1e-6), ("pnp", 1e-3)):
        kw = {"scale_factors": {MODEL: 0.4}} if method == "pnp" else {}
        for mm in (None, mug_meta):
            ours = tpose.process_frame(base, K, method=method, mug_meta=mm, **kw)
            ref = jpose.process_frame(base, K, method=method, mug_meta=mm, **kw)
            _same_label(ours, ref, atol)
        assert ours["instance_ids"] == [7]
    ours = tpose.process_frame(base, K, method="umeyama")
    np.testing.assert_allclose(ours["translations"][0], t_gt, atol=0.02)
    with pytest.raises(KeyError):
        tpose.process_frame(base, K, method="pnp", scale_factors={})


def test_merge_test_gts_matches_jax(tmp_path):
    base, K, t_gt = _write_frame(tmp_path, "0000", "png")
    s_gt = 0.4
    sRT = np.identity(4)
    sRT[:3, :3] = s_gt * np.eye(3)
    sRT[:3, 3] = t_gt
    nocs_gt = {"gt_class_ids": np.array([3, 1]), "gt_bboxes": np.array([[0, 0, 10, 10],
                                                                        [200, 280, 279, 359]]),
               "gt_RTs": np.stack([np.identity(4), sRT]),
               "gt_handle_visibility": np.array([1, 0])}
    models = {MODEL: np.array([[0.3, 0.5, 0.2], [-0.3, -0.5, -0.2]])}
    sizes = tpose.model_sizes_from_points(models)
    for k, v in jpose.model_sizes_from_points(models).items():
        assert np.array_equal(sizes[k], v)
    mug_meta = {MODEL: (np.array([0.01, -0.02, 0.03]), 1.2)}
    for mm in (None, mug_meta):
        _same_label(tpose.merge_test_gts(base, nocs_gt, sizes, mug_meta=mm),
                    jpose.merge_test_gts(base, nocs_gt, sizes, mug_meta=mm), 1e-6)
    assert tpose.nocs_scale_factors({"m": [3.0, 4.0, 0.0]}) == \
        jpose.nocs_scale_factors({"m": [3.0, 4.0, 0.0]})
    bad = dict(nocs_gt, gt_bboxes=np.array([[0, 0, 10, 10], [0, 0, 20, 20]]))
    with pytest.raises(AssertionError):
        tpose.merge_test_gts(base, bad, sizes)
    assert tpose.merge_test_gts(str(tmp_path / "missing"), nocs_gt, sizes) is None


def test_alpha_mask_raises_and_img_list(tmp_path):
    cv2 = pytest.importorskip("cv2")
    base, K, _ = _write_frame(tmp_path, "0000", "png")
    mask = png.read_png(base + "_mask.png")
    cv2.imwrite(base + "_mask.png", np.stack([mask] * 4, axis=2))      # RGBA
    with pytest.raises(ValueError, match="alpha"):
        tpose.process_frame(base, K)
    split = tmp_path / "real_test"
    for scene, ims in (("scene_2", ("0001", "0000")), ("scene_1", ("0003",))):
        (split / scene).mkdir(parents=True)
        for im in ims:
            (split / scene / f"{im}_color.png").write_bytes(b"")
    ours = tpose.create_img_list(str(split), str(tmp_path / "a.txt"))
    assert ours == jpose.create_img_list(str(split), str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_prepare_init_results_json_equal(tmp_path):
    rng = np.random.default_rng(5)
    pose_dir, seg_dir = tmp_path / "pose", tmp_path / "seg"
    pose_dir.mkdir()
    seg_dir.mkdir()
    for scene, im in (("1", "0000"), ("2", "0003")):
        n = 3
        RTs = np.zeros((n, 4, 4))
        for i in range(n):
            RTs[i, :3, :3] = rng.uniform(0.5, 1.5) * _rand_rot(rng)
            RTs[i, :3, 3] = rng.normal(size=3)
            RTs[i, 3, 3] = 1
        preds = {"pred_RTs": RTs, "pred_scales": rng.uniform(0.2, 0.6, (n, 3)),
                 "pred_class_ids": np.array([1, 3, 6]),
                 "pred_bboxes": rng.integers(0, 400, (n, 4)),
                 "pred_scores": rng.uniform(size=n), "gt_handle_visibility": np.array([1, 1, 0])}
        with open(pose_dir / f"results_test_scene_{scene}_{im}.pkl", "wb") as f:
            pickle.dump(preds, f)
        with open(seg_dir / f"results_test_scene_{scene}_{im}.pkl", "wb") as f:
            pickle.dump({"masks": rng.uniform(size=(48, 64, n)) > 0.6}, f)
    outs = []
    for mod, name in ((tprep, "port"), (jprep, "jax")):
        out = tmp_path / name / "init.json"
        args = ["--pose-dir", str(pose_dir), "--seg-dir", str(seg_dir), "--out", str(out)]
        if mod is tprep:
            assert mod.main(args) == 0
        else:
            import sys

            old = sys.argv
            sys.argv = ["x", *args]
            try:
                mod.main()
            finally:
                sys.argv = old
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1] and sorted(outs[0]) == ["scene_1/0000", "scene_2/0003"]


def _table(path, avg):
    rows = [["objects", "bottle", "bowl", "camera", "can", "laptop", "mug", "Avg(6)"]]
    for name, v in avg.items():
        rows.append([name] + ["1.00"] * 6 + [f"{v:.2f}"])
    path.write_text("\n".join("  ".join(r) for r in rows) + "\n")


@pytest.mark.parametrize("budget", ["0.5", "0.05"])
def test_repro_diff_output_and_exit_code(tmp_path, capsys, budget):
    _table(tmp_path / "metrics_tab_iter4.txt", {"IoU75": 43.61, "re5te2": 20.1, "IoU50": 70.0})
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({"IoU75": 43.6, "re5te2": 20.0, "missing": 1.0}))
    argv = [str(tmp_path), str(ref), "--budget", budget]
    rcs, outs = [], []
    for mod in (trepro, jrepro):
        rcs.append(mod.main(argv))
        outs.append(capsys.readouterr())
    assert rcs[0] == rcs[1] == (0 if budget == "0.5" else 1)
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err


def test_trainrun_report_output_and_exit_code(tmp_path, capsys):
    lines = [json.dumps({"iteration": i, "loss_total": 1.0 / (i + 1), "lr": 1e-4 * i,
                         "iter3/error_R": 10.0 - i, "iter3/error_t": 0.1 * i}) for i in range(9)]
    lines.insert(3, "not json")
    lines.append(json.dumps({"iteration": 8, "loss_total": 0.05, "lr": 1e-3,
                             "iter3/error_R": 1.0, "iter3/error_t": 0.2}))   # a resumed run
    (tmp_path / "metrics.json").write_text("\n".join(lines) + "\n")
    log = tmp_path / "log.txt"
    log.write_text("".join(f"2026-01-01 00:00:{2 * i:02d},123 catre INFO: iter {10 * i}/100\n"
                           for i in range(8)))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "metrics.json").write_text("")
    got = []
    for argv in ([str(tmp_path), "--points", "4", "--log", str(log)], [str(tmp_path)],
                 [str(empty)]):
        rcs, outs = [], []
        for mod in (treport, jreport):
            rcs.append(mod.main(argv))
            outs.append(capsys.readouterr().out)
        assert rcs[0] == rcs[1] and outs[0] == outs[1], argv
        got.append((rcs[0], outs[0]))
    assert [rc for rc, _ in got] == [0, 0, 1]
    assert "steady-state: 200 ms/iter" in got[0][1] and "| 8 | 0.05 |" in got[0][1]


def test_fetch_assets_output_and_exit_code(tmp_path, capsys, monkeypatch):
    root = tmp_path / "data"
    rel = [r for r, _, _ in jfetch.EXPECTED]
    assert rel == [r for r, _, _ in tfetch.EXPECTED]
    for present in (0, len(rel)):
        for r in rel[:present]:
            (root / r).parent.mkdir(parents=True, exist_ok=True)
            (root / r).write_text("x\n")
        if present:
            lst = root / "NOCS" / "REAL" / "real_test_list_all.txt"
            lst.write_text("real_test/scene_1/0000\n")
            frame = root / "NOCS" / "REAL" / "real_test" / "scene_1"
            frame.mkdir(parents=True)
            (frame / "0000_depth.png").write_bytes(b"")
            (frame / "0000_label.pkl").write_bytes(b"")
        rcs, outs = [], []
        for mod in (tfetch, jfetch):
            monkeypatch.setattr("sys.argv", ["x", "--data-root", str(root)])
            rcs.append(mod.main(["--data-root", str(root)]) if mod is tfetch else mod.main())
            outs.append(capsys.readouterr().out.splitlines())
        assert rcs[0] == rcs[1] == (0 if present else 1)
        # every line but the closing hint, which names each package's own command
        assert outs[0][:-1] == [o.replace("catre_tpu.tools", "catre_tpu_torch.tools")
                                for o in outs[1][:-1]]
        if present:
            assert "catre_tpu_torch.main" in outs[0][-1] and "--eval-only" in outs[0][-1]


def test_fps_sample_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    models = {"train": {f"bottle_{i}": rng.normal(size=(n, 3)).astype(np.float32)
                        for i, n in enumerate((200, 200, 150))},
              "test": {"mug_0": rng.normal(size=(120, 3)).astype(np.float32)}}
    monkeypatch.setattr(jassets, "load_model_points", lambda split="test": models[split])
    monkeypatch.setattr(tassets, "load_model_points", lambda split="test": models[split])
    for split in ("both", "test"):
        ours, ref = tmp_path / f"port_{split}.pkl", tmp_path / f"jax_{split}.pkl"
        assert tfps.main(["--split", split, "--num-points", "16", "--out", str(ours),
                          "--device", "cpu"]) == 0
        monkeypatch.setattr("sys.argv", ["x", "--split", split, "--num-points", "16",
                                         "--out", str(ref)])
        jfps.main()
        a, b = pickle.loads(ours.read_bytes()), pickle.loads(ref.read_bytes())
        assert list(a) == list(b)
        for inst in a:
            assert list(a[inst]) == ["fps16_and_center"]
            np.testing.assert_array_equal(a[inst]["fps16_and_center"], b[inst]["fps16_and_center"])
    assert os.path.exists(ours)
