"""Two-view epipolar geometry: F/E estimation, triangulation, cheirality.

Batched re-design of the reference's TwoView toolkit (reference
include/two.hpp:14-93, src/two.cpp:8-298) and the math half of the ORB-SLAM
style initializer (src/initialization.cpp:135-541):

* 8-point fundamental matrix by weighted DLT over fixed-capacity match
  arrays (masked rows), two normalization variants — mean-absolute-deviation
  (initialization.cpp:365-410) and Hartley similarity;
* rank-2 projection (``clean_F``, src/two.cpp:113-127);
* E = K^T F K and the 4-hypothesis (R, t) decomposition via the W-matrix
  construction with det fix (src/two.cpp:134-156, initialization.cpp:522-541);
* batched DLT triangulation — the reference does one 4x4 SVD per point per
  hypothesis (src/two.cpp:238-254); here all N x 4 hypotheses solve in one
  batched eigh of the 4x4 Gram matrices (no host loop);
* cheirality disambiguation with parallax + reprojection gating — the union
  of the simple z>0 count (src/two.cpp:256-298) and ORB-SLAM CheckRT
  (initialization.cpp:412-520).

Every function takes [N, ...] arrays + a weight/mask vector and jits with
static shapes; RANSAC lives in geometry/ransac.py and vmaps these.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from dr3_tpu.geometry.linalg import smallest_eigvec_gram


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def normalize_mad(pts: jnp.ndarray, weights: jnp.ndarray):
    """Mean-absolute-deviation normalization (reference Normalize,
    src/initialization.cpp:365-410): subtract centroid, scale each axis by
    1/meanAbsDev. Returns (pts_n [N,2], T [3,3])."""
    wsum = jnp.maximum(jnp.sum(weights), 1e-9)
    mean = jnp.sum(pts * weights[:, None], axis=0) / wsum
    centered = pts - mean
    mad = jnp.sum(jnp.abs(centered) * weights[:, None], axis=0) / wsum
    s = 1.0 / jnp.maximum(mad, 1e-9)
    pts_n = centered * s
    T = jnp.zeros((3, 3), pts.dtype)
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1]).at[2, 2].set(1.0)
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return pts_n, T


# ---------------------------------------------------------------------------
# fundamental / essential matrices
# ---------------------------------------------------------------------------

def fit_fundamental(p1: jnp.ndarray, p2: jnp.ndarray, weights: jnp.ndarray | None = None,
                    normalize: str = "mad") -> jnp.ndarray:
    """Weighted 8-point F with x2^T F x1 = 0 (reference ComputeF21,
    src/initialization.cpp:135-169; DLT rows of src/two.cpp:60-87).

    p1, p2: [N, 2] matched pixels; weights: [N] mask. normalize: 'mad'
    (initializer variant), 'hartley', or 'none'.
    """
    n = p1.shape[0]
    if weights is None:
        weights = jnp.ones((n,), p1.dtype)
    if normalize == "mad":
        p1n, T1 = normalize_mad(p1, weights)
        p2n, T2 = normalize_mad(p2, weights)
    elif normalize == "hartley":
        from dr3_tpu.geometry.homography import normalize_points
        p1n, T1 = normalize_points(p1, weights)
        p2n, T2 = normalize_points(p2, weights)
    else:
        p1n, p2n = p1, p2
        T1 = T2 = jnp.eye(3, dtype=p1.dtype)

    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    one = jnp.ones_like(x1)
    # rows [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1] for x2^T F x1 = 0
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1)
    A = A * weights[:, None]
    f = smallest_eigvec_gram(A)
    Fn = f.reshape(3, 3)
    Fn = enforce_rank2(Fn)
    F = T2.T @ Fn @ T1
    norm = jnp.linalg.norm(F)
    return F / jnp.where(norm < 1e-12, 1e-12, norm)


def enforce_rank2(F: jnp.ndarray) -> jnp.ndarray:
    """Project to the closest rank-2 matrix (clean_F, src/two.cpp:113-127)."""
    U, s, Vt = jnp.linalg.svd(F, full_matrices=False)
    s = s.at[2].set(0.0)
    return (U * s[None, :]) @ Vt


def essential_from_fundamental(F: jnp.ndarray, K1: jnp.ndarray, K2: jnp.ndarray | None = None) -> jnp.ndarray:
    """E = K2^T F K1 (src/two.cpp:139; initialization.cpp:263)."""
    if K2 is None:
        K2 = K1
    return K2.T @ F @ K1


def epipolar_errors(F: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray):
    """Squared point-to-epipolar-line distances both directions.

    Matches the reference CheckFundamental scoring residuals
    (src/initialization.cpp:171-249): for each match return
    (d2(x2, F x1), d1(x1, F^T x2)) with line-normalized distances.
    """
    one = jnp.ones_like(p1[..., :1])
    x1 = jnp.concatenate([p1, one], axis=-1)  # [N,3]
    x2 = jnp.concatenate([p2, one], axis=-1)
    l2 = x1 @ F.T  # lines in image 2: F x1
    l1 = x2 @ F    # lines in image 1: F^T x2
    num2 = jnp.sum(l2 * x2, axis=-1) ** 2
    num1 = jnp.sum(l1 * x1, axis=-1) ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    d2 = num2 / jnp.maximum(den2, 1e-12)
    d1 = num1 / jnp.maximum(den1, 1e-12)
    return d1, d2


def score_fundamental(F: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray,
                      weights: jnp.ndarray, sigma: float = 1.0,
                      th: float = 3.841, th_score: float = 5.991):
    """ORB-SLAM symmetric-transfer chi-square score (initialization.cpp:171-249).

    Returns (score, inlier_mask): each direction contributes
    (th_score - chi2) when chi2 < th; a match is an inlier when both
    directions pass.
    """
    d1, d2 = epipolar_errors(F, p1, p2)
    inv_sigma2 = 1.0 / (sigma * sigma)
    chi1 = d1 * inv_sigma2
    chi2 = d2 * inv_sigma2
    ok1 = chi1 <= th
    ok2 = chi2 <= th
    score = jnp.sum(jnp.where(ok1, th_score - chi1, 0.0) * weights) + \
        jnp.sum(jnp.where(ok2, th_score - chi2, 0.0) * weights)
    inliers = ok1 & ok2 & (weights > 0)
    return score, inliers


# ---------------------------------------------------------------------------
# E decomposition -> 4 pose hypotheses
# ---------------------------------------------------------------------------

class PoseHypotheses(NamedTuple):
    R: jnp.ndarray  # [4, 3, 3]
    t: jnp.ndarray  # [4, 3] unit-norm


def decompose_essential(E: jnp.ndarray) -> PoseHypotheses:
    """E -> four (R, t) candidates (extract_camera_pose, src/two.cpp:134-156;
    DecomposeE, src/initialization.cpp:522-541): R in {U W V^T, U W^T V^T},
    t = +-u3, with det(R) < 0 fixed by negating R."""
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    u3 = U[:, 2]
    u3 = u3 / jnp.maximum(jnp.linalg.norm(u3), 1e-12)
    R = jnp.stack([R1, R1, R2, R2])
    t = jnp.stack([u3, -u3, u3, -u3])
    return PoseHypotheses(R=R, t=t)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def triangulate(P1: jnp.ndarray, P2: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Batched DLT triangulation (reference per-point 4x4 SVD,
    src/two.cpp:238-254; initialization.cpp triangulate at :351-363).

    P1, P2: [..., 3, 4] projection matrices; p1, p2: [N, 2] pixels. Leading
    axes of P broadcast against N (e.g. [4, 1, 3, 4] P's with [N, 2] points
    triangulates all 4 hypotheses at once). Returns euclidean points
    [..., N, 3] (perspective divide with guard).
    """
    # rows: x*P3 - P1 ; y*P3 - P2, for both views -> A [..., N, 4, 4]
    def rows(P, p):
        P = P[..., None, :, :] if P.ndim == 2 else P  # allow unbatched
        x = p[..., 0][..., None]
        y = p[..., 1][..., None]
        r1 = x * P[..., 2, :] - P[..., 0, :]
        r2 = y * P[..., 2, :] - P[..., 1, :]
        return r1, r2

    a1, a2 = rows(P1, p1)
    a3, a4 = rows(P2, p2)
    A = jnp.stack(jnp.broadcast_arrays(a1, a2, a3, a4), axis=-2)  # [..., N, 4, 4]
    X = smallest_eigvec_gram(A)  # [..., N, 4]
    w = X[..., 3:4]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w


def projection_matrix(K: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """P = K [R | t], batched over leading axes of R/t."""
    Rt = jnp.concatenate([R, t[..., :, None]], axis=-1)
    return jnp.einsum("ij,...jk->...ik", K, Rt)


# ---------------------------------------------------------------------------
# cheirality + hypothesis selection
# ---------------------------------------------------------------------------

class CheckRTResult(NamedTuple):
    n_good: jnp.ndarray       # [] int
    good: jnp.ndarray         # [N] bool
    points: jnp.ndarray       # [N, 3] triangulated in cam-1/world frame
    parallax: jnp.ndarray     # [] 50th-smallest parallax in degrees


def check_rt(R: jnp.ndarray, t: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray,
             weights: jnp.ndarray, K: jnp.ndarray, sigma2: float = 1.0,
             min_parallax_cos: float = 0.99998) -> CheckRTResult:
    """ORB-SLAM CheckRT (reference src/initialization.cpp:412-520), batched.

    Camera 1 at origin; camera 2 at (R, t). A match is 'good' when its
    triangulated point is finite, has parallax cos < min_parallax_cos, sits
    in front of both cameras, and reprojects within 4*sigma2 in both views.
    Parallax statistic = 50th-smallest good parallax angle (deg), matching
    the reference's vCosParallax[idx] pick at :506-512.
    """
    P1 = projection_matrix(K, jnp.eye(3, dtype=K.dtype), jnp.zeros(3, K.dtype))
    P2 = projection_matrix(K, R, t)
    X = triangulate(P1, P2, p1, p2)  # [N, 3]

    finite = jnp.all(jnp.isfinite(X), axis=-1)
    O2 = -R.T @ t  # camera-2 center in cam-1 frame
    n1 = X
    n2 = X - O2
    d1 = jnp.linalg.norm(n1, axis=-1)
    d2 = jnp.linalg.norm(n2, axis=-1)
    cos_par = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(d1 * d2, 1e-12)

    z1 = X[..., 2]
    X2 = X @ R.T + t
    z2 = X2[..., 2]
    front = (z1 > 0) & (z2 > 0)

    # reprojection gate at 4 sigma^2 (initialization.cpp:478-499)
    def reproj(P, Xw):
        x = Xw @ P[:3, :3].T + P[:3, 3]
        z = jnp.where(jnp.abs(x[..., 2:3]) < 1e-12, 1e-12, x[..., 2:3])
        return x[..., :2] / z

    e1 = jnp.sum((reproj(P1, X) - p1) ** 2, axis=-1)
    e2 = jnp.sum((reproj(P2, X) - p2) ** 2, axis=-1)
    reproj_ok = (e1 <= 4.0 * sigma2) & (e2 <= 4.0 * sigma2)

    parallax_ok = cos_par < min_parallax_cos
    good = finite & front & reproj_ok & parallax_ok & (weights > 0)
    n_good = jnp.sum(good.astype(jnp.int32))

    # 50th-smallest parallax among good (or best available): sort cos desc
    # (large cos = small angle); reference picks min(50, n)-th smallest angle.
    cos_masked = jnp.where(good, cos_par, -2.0)  # bad -> sorted last for angles
    cos_sorted = -jnp.sort(-cos_masked)  # descending cos = ascending angle
    idx = jnp.minimum(50, jnp.maximum(n_good, 1)) - 1
    cos_sel = jnp.clip(cos_sorted[idx], -1.0, 1.0)
    parallax_deg = jnp.degrees(jnp.arccos(cos_sel))
    parallax_deg = jnp.where(n_good > 0, parallax_deg, 0.0)
    return CheckRTResult(n_good=n_good, good=good, points=X, parallax=parallax_deg)


def disambiguate_pose(hyp: PoseHypotheses, p1: jnp.ndarray, p2: jnp.ndarray,
                      weights: jnp.ndarray, K: jnp.ndarray, sigma2: float = 1.0):
    """Pick the (R, t) with most good points among the 4 hypotheses,
    requiring a clear winner like ReconstructF (initialization.cpp:286-306):
    second-best must be < 0.7 * best. Returns
    (best_idx, results_stacked, clear_winner: bool)."""
    import jax

    results = jax.vmap(lambda R, t: check_rt(R, t, p1, p2, weights, K, sigma2))(hyp.R, hyp.t)
    n = results.n_good
    best = jnp.argmax(n)
    nmax = n[best]
    n_similar = jnp.sum(n.astype(jnp.float32) > 0.7 * nmax)
    return best, results, n_similar == 1
