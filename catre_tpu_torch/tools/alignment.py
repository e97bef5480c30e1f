"""Offline gt-label math: Umeyama similarity alignment (with RANSAC) and PnP
pose recovery, in numpy.

Counterpart of `catre_tpu/tools/alignment.py`. `umeyama_similarity` and
`ransac_umeyama` are copies (the same draws from `default_rng(seed)`, the same
bits). `pnp_pose` stands in for `cv2.solvePnP` / `cv2.solvePnPRansac` with
`SOLVEPNP_EPNP` (:84-110): `epnp` is EPnP (Lepetit, Moreno-Noguer and Fua,
IJCV 2009) as OpenCV computes it (`calib3d/src/epnp.cpp`): four control
points (the centroid and the principal axes), the points' barycentric
coordinates through a pseudo-inverse, the null space of M^T M, betas for N =
1, 2 and 3 null vectors each refined by Gauss-Newton, and the pose of least
reprojection error. The RANSAC of `pnp_pose(ransac=True)` draws 5-point
subsets from an explicit `np.random.Generator` (OpenCV's draws cannot be
reproduced), keeps the hypothesis with the most points within `reproj_err`
pixels, stops at 99% confidence or `iterations`, and refits EPnP on its
inliers, as OpenCV does.

Behavioural reference: `preprocess/pose_data.py:56-166` (Umeyama + RANSAC,
CAMERA gt) and `:342-417` (PnP, REAL train gt).
"""

from __future__ import annotations

import numpy as np


def umeyama_similarity(source: np.ndarray, target: np.ndarray):
    """Least-squares similarity transform target ~ s R source + t.

    source, target: (N, 3). -> (scale, R (3, 3), t (3,), T (4, 4) with
    T[:3, :3] = s R)."""
    assert source.shape == target.shape and source.shape[1] == 3
    n = source.shape[0]
    mu_s = source.mean(axis=0)
    mu_t = target.mean(axis=0)
    cs = source - mu_s
    ct = target - mu_t
    cov = ct.T @ cs / n
    if np.isnan(cov).any():
        raise RuntimeError("NaNs in input points")
    U, D, Vh = np.linalg.svd(cov, full_matrices=True)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        D = D.copy()
        D[-1] = -D[-1]
        U = U.copy()
        U[:, -1] = -U[:, -1]
    R = U @ Vh
    var_s = cs.var(axis=0).sum()
    scale = D.sum() / var_s
    t = mu_t - scale * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = t
    return float(scale), R, t, T


def ransac_umeyama(source: np.ndarray, target: np.ndarray, max_iter: int = 128,
                   confidence: float = 0.99, seed: int = 0, verbose: bool = False):
    """RANSAC over `umeyama_similarity`: 5-point hypotheses, inliers within
    0.1 of the source diameter times the hypothesis scale
    (`pose_data.py:110-166`). -> (scale, R, t, T), or (None,) * 4 below 10%
    inliers."""
    assert source.shape[0] == target.shape[0]
    rng = np.random.default_rng(seed)
    n = source.shape[0]
    centered = source - source.mean(axis=0)
    diameter = 2 * np.linalg.norm(centered, axis=1).max()
    inlier_t = diameter / 10.0

    best_ratio = 0.0
    best_idx = np.arange(n)
    for i in range(max_iter):
        sel = rng.integers(0, n, size=5)
        try:
            scale, R, t, T = umeyama_similarity(source[sel], target[sel])
        except (RuntimeError, np.linalg.LinAlgError):
            continue
        thresh = scale * inlier_t
        resid = np.linalg.norm(target - (source @ (scale * R).T + t), axis=1)
        inliers = np.where(resid < thresh)[0]
        ratio = len(inliers) / n
        if ratio > best_ratio:
            best_ratio = ratio
            best_idx = inliers
        if (1 - (1 - best_ratio ** 5) ** (i + 1)) > confidence:
            break

    if best_ratio < 0.1:
        return None, None, None, None
    return umeyama_similarity(source[best_idx], target[best_idx])


# ---- EPnP

RANSAC_CONFIDENCE = 0.99     # solvePnPRansac's default
# the six pairs of control points whose distances the betas must keep
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _control_points(pw: np.ndarray) -> np.ndarray:
    """(4, 3): the centroid, then the centroid moved along each principal axis
    by the points' spread along it."""
    c0 = pw.mean(axis=0)
    d = pw - c0
    _, s, vt = np.linalg.svd(d.T @ d)
    k = np.sqrt(s / len(pw))
    return np.concatenate([c0[None], c0 + k[:, None] * vt], axis=0)


def _barycentric(pw: np.ndarray, cw: np.ndarray) -> np.ndarray:
    """(N, 4) alphas with pw = sum_j alpha_j cw_j; a pseudo-inverse, so that
    coplanar points (a control point on the centroid) give 0 on it."""
    cc = (cw[1:] - cw[0]).T
    a = (pw - cw[0]) @ np.linalg.pinv(cc).T
    return np.concatenate([1.0 - a.sum(axis=1, keepdims=True), a], axis=1)


def _m_matrix(alphas: np.ndarray, uv: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(2N, 12): each point's two projection equations in the control points'
    camera coordinates."""
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    n = len(alphas)
    m = np.zeros((n, 2, 4, 3))
    m[:, 0, :, 0] = alphas * fu
    m[:, 0, :, 2] = alphas * (uc - uv[:, :1])
    m[:, 1, :, 1] = alphas * fv
    m[:, 1, :, 2] = alphas * (vc - uv[:, 1:])
    return m.reshape(2 * n, 12)


def _l_6x10(v: np.ndarray) -> np.ndarray:
    """(6, 10): the squared distances of the control-point pairs as linear
    forms of [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]; v (4, 4, 3) the
    null vectors as control points."""
    dv = np.stack([v[:, a] - v[:, b] for a, b in _PAIRS], axis=1)     # (4, 6, 3)
    d = lambda i, j: (dv[i] * dv[j]).sum(axis=1)                      # noqa: E731
    return np.stack([d(0, 0), 2 * d(0, 1), d(1, 1), 2 * d(0, 2), 2 * d(1, 2), d(2, 2),
                     2 * d(0, 3), 2 * d(1, 3), 2 * d(2, 3), d(3, 3)], axis=1)


def _lstsq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.lstsq(a, b, rcond=None)[0]


def _betas_n1(L: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """N = 4 read as one beta and its products: [b11, b12, b13, b14]."""
    b4 = _lstsq(L[:, [0, 1, 3, 6]], rho)
    if b4[0] < 0:
        b4 = -b4
    b0 = np.sqrt(b4[0])
    return np.array([b0, b4[1] / b0, b4[2] / b0, b4[3] / b0])


def _leading_pair(b: np.ndarray):
    """[b11, b12, b22, ...] -> (beta1, beta2): square roots, beta2 0 where b22
    has the other sign, beta1 carrying b12's sign (OpenCV's rule)."""
    sign = -1.0 if b[0] < 0 else 1.0
    b0 = np.sqrt(sign * b[0])
    b1 = np.sqrt(sign * b[2]) if sign * b[2] > 0 else 0.0
    return (-b0 if b[1] < 0 else b0), b1


def _betas_n2(L: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """Two null vectors: [b11, b12, b22]."""
    b0, b1 = _leading_pair(_lstsq(L[:, [0, 1, 2]], rho))
    return np.array([b0, b1, 0.0, 0.0])


def _betas_n3(L: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """Three null vectors: [b11, b12, b22, b13, b23]."""
    b5 = _lstsq(L[:, :5], rho)
    b0, b1 = _leading_pair(b5)
    return np.array([b0, b1, b5[3] / b0, 0.0])


def _gauss_newton(L: np.ndarray, rho: np.ndarray, betas: np.ndarray,
                  iterations: int = 5) -> np.ndarray:
    for _ in range(iterations):
        b0, b1, b2, b3 = betas
        prod = np.array([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2, b2 * b2,
                         b0 * b3, b1 * b3, b2 * b3, b3 * b3])
        c = L.T
        jac = np.stack([2 * c[0] * b0 + c[1] * b1 + c[3] * b2 + c[6] * b3,
                        c[1] * b0 + 2 * c[2] * b1 + c[4] * b2 + c[7] * b3,
                        c[3] * b0 + c[4] * b1 + 2 * c[5] * b2 + c[8] * b3,
                        c[6] * b0 + c[7] * b1 + c[8] * b2 + 2 * c[9] * b3], axis=1)
        betas = betas + _lstsq(jac, rho - L @ prod)
    return betas


def _pose_from_betas(v: np.ndarray, betas: np.ndarray, alphas: np.ndarray, pw: np.ndarray,
                     uv: np.ndarray, K: np.ndarray):
    """Control points in the camera from the betas, the points' camera
    coordinates, then R, t by Procrustes. -> (R, t, mean reprojection error)."""
    cc = np.tensordot(betas, v, axes=1)                 # (4, 3)
    pc = alphas @ cc
    if pc[0, 2] < 0:
        pc = -pc
    pc0, pw0 = pc.mean(axis=0), pw.mean(axis=0)
    u, _, vt = np.linalg.svd((pc - pc0).T @ (pw - pw0))
    R = u @ vt
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    t = pc0 - R @ pw0
    return R, t, _reprojection_errors(pw, uv, K, R, t).mean()


def _reprojection_errors(pw, uv, K, R, t) -> np.ndarray:
    cam = pw @ R.T + t
    proj = cam @ K.T
    return np.linalg.norm(proj[:, :2] / proj[:, 2:] - uv, axis=1)


def epnp(points_3d: np.ndarray, points_2d: np.ndarray, K: np.ndarray):
    """EPnP on N >= 4 correspondences (no distortion). -> (R (3, 3), t (3,))
    in float64."""
    pw = np.asarray(points_3d, np.float64).reshape(-1, 3)
    uv = np.asarray(points_2d, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    cw = _control_points(pw)
    alphas = _barycentric(pw, cw)
    m = _m_matrix(alphas, uv, K)
    _, _, vt = np.linalg.svd(m.T @ m)
    v = vt[::-1][:4].reshape(4, 4, 3)                  # the four least singular vectors
    L = _l_6x10(v)
    rho = np.array([((cw[a] - cw[b]) ** 2).sum() for a, b in _PAIRS])
    best = None
    for approx in (_betas_n1, _betas_n2, _betas_n3):
        pose = _pose_from_betas(v, _gauss_newton(L, rho, approx(L, rho)), alphas, pw, uv, K)
        if best is None or pose[2] < best[2]:
            best = pose
    return best[0], best[1]


def _ransac_iterations(confidence: float, inlier_ratio: float, sample: int, cap: int) -> int:
    """OpenCV's `RANSACUpdateNumIters`: draws that find an all-inlier sample
    with `confidence`."""
    p_good = inlier_ratio ** sample
    if p_good >= 1.0:
        return 0
    if p_good <= 0.0:
        return cap
    return min(cap, int(np.ceil(np.log(1.0 - confidence) / np.log(1.0 - p_good))))


def pnp_pose(points_3d: np.ndarray, points_2d: np.ndarray, K: np.ndarray,
             ransac: bool = True, reproj_err: float = 3.0, iterations: int = 100,
             rng: np.random.Generator | None = None):
    """[R | t] from 3D-2D correspondences by EPnP (`epnp`), the stand-in for
    cv2.solvePnP / solvePnPRansac with SOLVEPNP_EPNP (`lib/pysixd/misc.pnp`).

    points_3d (N, 3), points_2d (N, 2), K (3, 3). `ransac`: 5-point draws
    from `rng` (default `default_rng(0)`), at most `iterations`, inliers
    within `reproj_err` pixels, stopping early at 99% confidence, then EPnP on
    the best draw's inliers (all points where no draw finds 5 inliers). ->
    (3, 4) float32."""
    pw = np.asarray(points_3d, np.float64).reshape(-1, 3)
    uv = np.asarray(points_2d, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    if len(pw) < 4:
        raise ValueError(f"PnP needs at least 4 correspondences, got {len(pw)}")
    keep = np.arange(len(pw))
    if ransac and len(pw) > 5:
        rng = np.random.default_rng(0) if rng is None else rng
        best, cap, i = None, int(iterations), 0
        while i < cap:
            i += 1
            sel = rng.choice(len(pw), size=5, replace=False)
            try:
                R, t = epnp(pw[sel], uv[sel], K)
            except np.linalg.LinAlgError:
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                inliers = np.flatnonzero(_reprojection_errors(pw, uv, K, R, t) <= reproj_err)
            if best is None or len(inliers) > len(best):
                best = inliers
                cap = min(cap, _ransac_iterations(RANSAC_CONFIDENCE, len(best) / len(pw), 5,
                                                  int(iterations)))
        if best is not None and len(best) >= 5:
            keep = best
    R, t = epnp(pw[keep], uv[keep], K)
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)
