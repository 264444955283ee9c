"""Observation-keyed Schur-complement solver core.

The reduced camera system of bundle adjustment is

    S dc = rhs,   S = Hcc - W Hpp^-1 W^T,

where the coupling W is block-sparse with one [C, 3] block per observation
(camera tangent dim C = 6 for SE3 cameras, 9 for Snavely cameras). The
round-1 solver materialized W densely as [K, P, 6, 3] — O(K*P) memory,
impossible at BAL scale (Ceres' DENSE_SCHUR never forms W densely either;
reference src/optimizer.cpp:155-166 relies on Ceres' partitioned views).

This core assembles everything **per observation** and offers two solves:

* ``explicit`` — exact DENSE_SCHUR math. Observations are grouped by point
  through a static-depth ``[P, d_max]`` index table; the cross-camera
  correction sum_p W_(k1,p) Hpp^-1_p W_(k2,p)^T accumulates with a
  ``fori_loop`` of segment-sums over observation *pairs* sharing a point.
  Memory O(O + P*d_max + K^2 C^2). Right for window/pose-graph K (<= ~64).
* ``zexplicit`` — the same exact DENSE_SCHUR math through a square-root
  factorization: with Hpp^-1 = L L^T per point, the correction is Z^T Z for
  Z [3P, CK] built by one collision-free scatter of per-observation
  L^T AtB^T blocks, so the whole correction is ONE matmul (the C-dim
  generalization of ba/snavely.py's BAL fast path). Fastest exact path at
  window scale; memory O(P*K*C).
* ``pcg`` — matrix-free preconditioned conjugate gradients on S with the
  block-Jacobi preconditioner (SCHUR_JACOBI — the reference's own choice,
  src/optimizer.cpp:161). Memory O(O + K C^2); scales to BAL-sized camera
  counts where the dense S Cholesky would dominate.

An optional *global* parameter block g of size G (the shared fx/fy/cx/cy
intrinsics the reference optimizes as a 4-param block,
include/optimizer.hpp:114-118, src/optimizer.cpp:144-153) is eliminated
jointly with the cameras in BOTH paths: explicitly the reduced system
becomes [(K*C + G) x (K*C + G)]; in the pcg path the tiny global couplings
(S_gc [K, G, C], S_gg [G, G]) assemble explicitly and border the
matrix-free camera operator, so CG runs on the exact same system.

Everything is static-shape, jit- and shard_map-safe; padding observations
must carry zero rows in r/J (linearize folds weights in) and
``active=False`` so they never consume point-table slots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dr3_tpu.geometry.linalg import chol3, chol_solve_small, inv3x3


class SchurBlocks(NamedTuple):
    """Normal-equation blocks, observation-keyed (no dense W anywhere)."""

    Hcc: jnp.ndarray            # [K, C, C] camera diagonal blocks
    bc: jnp.ndarray             # [K, C]
    Hpp: jnp.ndarray            # [P, 3, 3] point diagonal blocks
    bp: jnp.ndarray             # [P, 3]
    AtB: jnp.ndarray            # [O, C, 3] per-observation coupling blocks
    obs_cam: jnp.ndarray        # [O] int32
    obs_pt: jnp.ndarray         # [O] int32 (clamped to [0, P))
    active: jnp.ndarray         # [O] bool — False rows are padding
    Hgg: Optional[jnp.ndarray] = None   # [G, G] global block
    Hgc: Optional[jnp.ndarray] = None   # [K, G, C] global-camera coupling
    bg: Optional[jnp.ndarray] = None    # [G]
    GtB: Optional[jnp.ndarray] = None   # [O, G, 3] global-point coupling


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (in the absence of overflow)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _comp_add(x, y):
    """Compensated (hi, lo) pair addition — the associative-scan combiner."""
    h1, l1 = x
    h2, l2 = y
    s, e = _two_sum(h1, h2)
    return _two_sum(s, l1 + l2 + e)


def segment_boundaries(seg_ids_sorted, num_segments: int):
    """(starts, ends) [S] row ranges of each segment in a SORTED id array."""
    q = jnp.arange(num_segments, dtype=seg_ids_sorted.dtype)
    starts = jnp.searchsorted(seg_ids_sorted, q, side="left")
    ends = jnp.searchsorted(seg_ids_sorted, q, side="right")
    return starts, ends


def sorted_segment_sum(terms, seg_ids, num_segments: int, *,
                       starts=None, ends=None):
    """``segment_sum`` for terms already SORTED by segment id.

    A prefix scan + boundary difference replaces the scatter-add with
    pure bandwidth (no colliding updates). Accuracy: the
    prefix runs in two-float compensated arithmetic (TwoSum pairs, ~48
    effective mantissa bits) and the boundary difference is taken in pair
    arithmetic, so each segment sum is accurate to ~f32 eps of its own
    magnitude even when the global prefix is 1e5x larger — a plain f32
    cumsum would lose ALL bits of a depth-8 segment at O=480k.

    ``starts``/``ends`` (from :func:`segment_boundaries`) are index data
    that callers with an iteration loop should compute once and reuse.
    """
    O = terms.shape[0]
    flat = terms.reshape(O, -1)
    hi, lo = jax.lax.associative_scan(
        _comp_add, (flat, jnp.zeros_like(flat)), axis=0)
    zhi = jnp.concatenate([jnp.zeros_like(hi[:1]), hi])
    zlo = jnp.concatenate([jnp.zeros_like(lo[:1]), lo])
    if starts is None:
        starts, ends = segment_boundaries(seg_ids, num_segments)
    d_hi, d_err = _two_sum(zhi[ends], -zhi[starts])
    out = d_hi + (d_err + (zlo[ends] - zlo[starts]))
    return out.reshape((num_segments,) + terms.shape[1:])


def cam_onehot_matrix(obs_cam, n_cams: int, dtype=jnp.float32):
    """[O, K] exact 0/1 camera-membership matrix for matmul reductions."""
    oc = jnp.clip(obs_cam, 0, n_cams - 1)
    return (oc[:, None]
            == jnp.arange(n_cams, dtype=oc.dtype)[None, :]).astype(dtype)


def assemble_blocks(r, Jc, Jp, obs_cam, obs_pt, active, n_cams: int,
                    n_points: int, Jg=None, cam_onehot=None,
                    point_sorted: bool = False) -> SchurBlocks:
    """One pass over the observation table -> all normal-equation blocks.

    r [O, 2], Jc [O, 2, C], Jp [O, 2, 3] must already carry the robust /
    validity weights (zero rows for padding), as produced by
    :func:`dr3_tpu.ba.problem.linearize`.

    ``cam_onehot`` (optional, from :func:`cam_onehot_matrix`): routes the
    camera-keyed reductions through exact-0/1 matmuls instead of
    segment_sum scatter-adds (K is small, so every update of a
    segment_sum collides with many others). Callers with an LM loop
    should build E once and reuse it every iteration.
    ``point_sorted``: the observation table is sorted by point id — the
    point-keyed reductions then run as compensated prefix scans
    (:func:`sorted_segment_sum`) instead of scatter-adds. A [O, P]
    one-hot is not representable at 60k points, so this is the point-side
    analogue of the camera one-hot trick."""
    oc = jnp.clip(obs_cam, 0, n_cams - 1)
    op = jnp.clip(obs_pt, 0, n_points - 1)

    def by_pt(terms):
        if point_sorted:
            return sorted_segment_sum(terms, op, n_points)
        return jax.ops.segment_sum(terms, op, num_segments=n_points)

    AtA = jnp.einsum("oij,oik->ojk", Jc, Jc)
    BtB = jnp.einsum("oij,oik->ojk", Jp, Jp)
    AtB = jnp.einsum("oij,oik->ojk", Jc, Jp)
    Atr = jnp.einsum("oij,oi->oj", Jc, r)
    Btr = jnp.einsum("oij,oi->oj", Jp, r)

    def by_cam(terms):
        if cam_onehot is None:
            return jax.ops.segment_sum(terms, oc, num_segments=n_cams)
        flat = terms.reshape(terms.shape[0], -1)
        out = jax.lax.dot_general(cam_onehot, flat, (((0,), (0,)), ((), ())),
                                  precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)
        return out.reshape((n_cams,) + terms.shape[1:])

    Hcc = by_cam(AtA)
    Hpp = by_pt(BtB)
    bc = -by_cam(Atr)
    bp = -by_pt(Btr)

    Hgg = Hgc = bg = GtB = None
    if Jg is not None:
        Hgg = jnp.einsum("oij,oik->jk", Jg, Jg)
        GtA = jnp.einsum("oij,oik->ojk", Jg, Jc)            # [O, G, C]
        Hgc = by_cam(GtA)
        bg = -jnp.einsum("oij,oi->j", Jg, r)
        GtB = jnp.einsum("oij,oik->ojk", Jg, Jp)            # [O, G, 3]

    return SchurBlocks(Hcc=Hcc, bc=bc, Hpp=Hpp, bp=bp, AtB=AtB,
                       obs_cam=oc, obs_pt=op, active=active,
                       Hgg=Hgg, Hgc=Hgc, bg=bg, GtB=GtB)


def group_by_point(obs_pt, active, n_points: int, d_max: int) -> jnp.ndarray:
    """[P, d_max] table of observation indices per point (pad value = O).

    Static-shape grouping: sort observations by point id (inactive rows sort
    to a scratch bucket), rank each observation within its point via
    searchsorted, scatter into the table. Observations beyond ``d_max`` per
    point are dropped from the *pair* assembly only — pick d_max >= the max
    observations any point can have (window problems: one per camera, so
    d_max = K is exact).
    """
    O = obs_pt.shape[0]
    eff = jnp.where(active, obs_pt, n_points).astype(jnp.int32)
    order = jnp.argsort(eff)
    sorted_pt = eff[order]
    first = jnp.searchsorted(sorted_pt, sorted_pt, side="left")
    rank = jnp.arange(O, dtype=jnp.int32) - first.astype(jnp.int32)
    ok = (sorted_pt < n_points) & (rank < d_max)
    rows = jnp.where(ok, sorted_pt, n_points)
    cols = jnp.where(ok, rank, 0)
    tbl = jnp.full((n_points + 1, d_max), O, jnp.int32)
    tbl = tbl.at[rows, cols].set(order.astype(jnp.int32), mode="drop")
    return tbl[:n_points]


def _damp(H, lam, floor=1e-8):
    n = H.shape[-1]
    eye = jnp.eye(n, dtype=H.dtype)
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    return H + eye * (lam * diag + floor)[..., None, :]


def _explicit_s_corr(WHinv_pad, AtB_pad, cam_pad, pt_table, n_cams: int):
    """sum over observation pairs sharing a point of
    WHinv_(o1) @ AtB_(o2)^T scattered to S[cam_o1, cam_o2] — the
    W Hpp^-1 W^T correction, assembled without forming W.

    *_pad arrays have one extra zero row at index O (the table's pad value),
    so padded slots contribute exactly zero.
    """
    P, D = pt_table.shape
    C = AtB_pad.shape[-2]
    Wp = AtB_pad[pt_table]          # [P, D, C, 3]
    WHp = WHinv_pad[pt_table]       # [P, D, C, 3]
    cams_p = cam_pad[pt_table]      # [P, D] (pad rows -> cam 0, contrib 0)

    def body(d1, s_flat):
        wh1 = WHp[:, d1]                      # [P, C, 3]
        c1 = cams_p[:, d1]                    # [P]
        contrib = jnp.einsum("pij,pdkj->pdik", wh1, Wp)   # [P, D, C, C]
        keys = (c1[:, None] * n_cams + cams_p).reshape(-1)
        return s_flat + jax.ops.segment_sum(
            contrib.reshape(-1, C, C), keys, num_segments=n_cams * n_cams)

    s_flat = jax.lax.fori_loop(
        0, D, body, jnp.zeros((n_cams * n_cams, C, C), AtB_pad.dtype))
    # [K*K, C, C] -> [K, C, K, C]
    return s_flat.reshape(n_cams, n_cams, C, C).transpose(0, 2, 1, 3)


def _explicit_s_corr_sqrt(Hpp_inv, AtB, obs_cam, obs_pt,
                          n_cams: int, n_points: int):
    """W Hpp^-1 W^T as Z^T Z — ONE collision-free scatter + ONE matmul.

    The square-root factorization of ba/snavely.py's BAL fast path
    (`_solve_explicit_direct`), generalized to C-dim camera blocks: with
    Hpp^-1_p = L_p L_p^T, the matrix Z in R^{3P x CK} whose (point, camera)
    block is L_p^T (Jp^T Jc)_o = L_p^T AtB_o^T satisfies
    sum_p W Hpp^-1 W^T = Z^T Z. Duplicate (cam, point) observations
    accumulate into the same block, which is exactly W_kp = sum_o AtB_o, so
    the scatter-ADD is correct for any observation multiplicity; padding
    rows carry zero AtB blocks (linearize folds weights) and contribute 0.

    vs `_explicit_s_corr_dense`: half the scratch ([3P, CK] once instead
    of U and V at [P, K, C, 3] each), one scatter instead of two, and half
    the matmul FLOPs (Z^T Z instead of U2 @ V2^T) — and it replaces the
    window-BA PCG loop (each CG iteration pays a point scatter + gather)
    with an exact solve, the round-5 change that took the in-scan keyframe
    path off the mapping-phase critical path.
    """
    O, C, _ = AtB.shape
    check_flat_scatter_size(3 * n_points * C * n_cams)
    Lo = chol3(Hpp_inv)[obs_pt]                          # [O, 3, 3] lower
    zupd = jnp.einsum("ojr,ocj->orc", Lo, AtB)           # [O, 3, C]
    rows = 3 * obs_pt[:, None] + jnp.arange(3, dtype=obs_pt.dtype)[None, :]
    cols = C * obs_cam[:, None] + jnp.arange(C, dtype=obs_cam.dtype)[None, :]
    flat = (rows[:, :, None] * (C * n_cams) + cols[:, None, :]).reshape(-1)
    Z = jnp.zeros((3 * n_points * C * n_cams,), AtB.dtype) \
        .at[flat].add(zupd.reshape(-1), mode="promise_in_bounds") \
        .reshape(3 * n_points, C * n_cams)
    S = jax.lax.dot_general(Z, Z, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return S.reshape(n_cams, C, n_cams, C)


def check_flat_scatter_size(n_elems: int) -> None:
    """Refuse, at trace time, a flat int32-indexed scatter target of
    ``n_elems`` elements that int32 cannot address. The dense-Z scatters
    use ``mode="promise_in_bounds"``, under which an out-of-range index is
    undefined behaviour on the GPU instead of a dropped update."""
    if n_elems >= 2 ** 31:
        raise ValueError(
            f"flat scatter of {n_elems} elements exceeds int32 indexing")


def _pad_obs(x):
    return jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)


# dense-W assembly is used when the [P, K, C, 3] scratch fits under this
# many float32 elements (64M = 256 MB x2 operands). Window problems
# (K<=64, P<=64k) fit easily; BAL-scale problems fall back to the
# pair-table loop / PCG.
_DENSE_W_MAX_ELEMS = 64 * 1024 * 1024


def _explicit_s_corr_dense(WHinv, AtB, obs_cam, obs_pt, active,
                           n_cams: int, n_points: int):
    """W Hpp^-1 W^T as ONE contraction.

    Scatter-adds the per-observation blocks into dense per-point
    [P, K, C, 3] tables and contracts over (point, 3) in a single matmul
    — O(P*K^2*C^2*3) matmul flops instead of the d_max-deep fori_loop of
    [P, d_max, C, C] segment-sums (which moves d_max/avg_depth times more
    HBM traffic than useful work when most points have few observations,
    ~50x for the 32-keyframe VO window).
    """
    C = AtB.shape[-2]
    w = active.astype(WHinv.dtype)
    U = jnp.zeros((n_points, n_cams, C, 3), WHinv.dtype)
    U = U.at[obs_pt, obs_cam].add(WHinv * w[:, None, None])
    V = jnp.zeros((n_points, n_cams, C, 3), AtB.dtype)
    V = V.at[obs_pt, obs_cam].add(AtB * w[:, None, None])
    U2 = U.transpose(1, 2, 0, 3).reshape(n_cams * C, n_points * 3)
    V2 = V.transpose(1, 2, 0, 3).reshape(n_cams * C, n_points * 3)
    S = jax.lax.dot_general(U2, V2, (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return S.reshape(n_cams, C, n_cams, C)


def solve_schur(blocks: SchurBlocks, lam, cam_fixed, *,
                method: str = "explicit", d_max: int | None = None,
                jacobi: bool = True, cg_iters: int = 100,
                cg_tol: float = 1e-5, q_eta: float = 0.0,
                point_sorted: bool = False):
    """One damped Schur solve -> (dc [K, C], dp [P, 3], dg [G] or None).

    ``point_sorted``: blocks' observation rows are sorted by point id, so
    every point-keyed reduction (including the one inside each CG
    iteration) runs as a compensated prefix scan instead of a
    scatter-add — see :func:`sorted_segment_sum`.
    """
    K, C = blocks.Hcc.shape[0], blocks.Hcc.shape[-1]
    P = blocks.Hpp.shape[0]
    has_g = blocks.Hgg is not None
    G = blocks.Hgg.shape[0] if has_g else 0

    if point_sorted:
        pt_starts, pt_ends = segment_boundaries(blocks.obs_pt, P)

        def by_pt(terms):
            return sorted_segment_sum(terms, blocks.obs_pt, P,
                                      starts=pt_starts, ends=pt_ends)
    else:
        def by_pt(terms):
            return jax.ops.segment_sum(terms, blocks.obs_pt, num_segments=P)

    Hpp_d = _damp(blocks.Hpp, lam)
    Hcc_d = _damp(blocks.Hcc, lam)
    Hpp_inv = inv3x3(Hpp_d)

    Hinv_o = Hpp_inv[blocks.obs_pt]                          # [O, 3, 3]
    WHinv = jnp.einsum("ocj,ojl->ocl", blocks.AtB, Hinv_o)   # [O, C, 3]
    bp_o = blocks.bp[blocks.obs_pt]                          # [O, 3]

    # one-hot camera-membership matrix: camera-keyed reductions and
    # broadcasts (rhs_c here, plus every CG iteration's operator) run as
    # matmuls against E instead of segment_sum/gather. E rows are
    # exact 0/1 so the contraction is exact at HIGHEST precision. Above
    # ~1 GB of one-hot (huge K*O) fall back to segment_sum/gather.
    O = blocks.obs_cam.shape[0]
    use_onehot = O * K <= 256 * 1024 * 1024
    E = None
    if use_onehot:
        E = (blocks.obs_cam[:, None] ==
             jnp.arange(K, dtype=jnp.int32)[None, :]).astype(Hcc_d.dtype)

    def by_cam(terms):
        """[O, ...] -> [K, ...]: sum of terms per camera."""
        if not use_onehot:
            return jax.ops.segment_sum(terms, blocks.obs_cam,
                                       num_segments=K)
        flat = terms.reshape(terms.shape[0], -1)
        out = jax.lax.dot_general(E, flat, (((0,), (0,)), ((), ())),
                                  precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)
        return out.reshape((K,) + terms.shape[1:])

    def to_obs(per_cam):
        """[K, C] -> [O, C]: per_cam[obs_cam]."""
        if not use_onehot:
            return per_cam[blocks.obs_cam]
        return jax.lax.dot_general(E, per_cam, (((1,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST,
                                   preferred_element_type=jnp.float32)

    rhs_c = blocks.bc - by_cam(jnp.einsum("ocl,ol->oc", WHinv, bp_o))

    keep = (~cam_fixed).astype(blocks.Hcc.dtype)
    keep_v = jnp.repeat(keep, C)
    if has_g:
        keep_v = jnp.concatenate([keep_v, jnp.ones((G,), keep.dtype)])

    if method in ("explicit", "zexplicit"):
        # dense Z and dense W hold the same P*K*C*3 elements: past the
        # ceiling both fall back to the pair-table loop
        fits_dense = P * K * C * 3 <= _DENSE_W_MAX_ELEMS
        if method == "zexplicit" and fits_dense:
            S_corr = _explicit_s_corr_sqrt(Hpp_inv, blocks.AtB,
                                           blocks.obs_cam, blocks.obs_pt,
                                           K, P)
        elif fits_dense:
            S_corr = _explicit_s_corr_dense(WHinv, blocks.AtB,
                                            blocks.obs_cam, blocks.obs_pt,
                                            blocks.active, K, P)
        else:
            if d_max is None:
                d_max = K
            tbl = group_by_point(blocks.obs_pt, blocks.active, P, d_max)
            S_corr = _explicit_s_corr(
                _pad_obs(WHinv), _pad_obs(blocks.AtB),
                jnp.concatenate([blocks.obs_cam,
                                 jnp.zeros((1,), jnp.int32)]),
                tbl, K)
        S = -S_corr
        S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hcc_d)
        S = S.reshape(K * C, K * C)
        rhs = rhs_c.reshape(K * C)

        if has_g:
            Hgg_d = _damp(blocks.Hgg, lam)
            Wg = by_pt(blocks.GtB)                            # [P, G, 3]
            WgHinv = jnp.einsum("pgj,pjl->pgl", Wg, Hpp_inv)  # [P, G, 3]
            S_gg = Hgg_d - jnp.einsum("pgl,phl->gh", WgHinv, Wg)
            S_gc = blocks.Hgc - jax.ops.segment_sum(
                jnp.einsum("ogl,ocl->ogc", WgHinv[blocks.obs_pt], blocks.AtB),
                blocks.obs_cam, num_segments=K)               # [K, G, C]
            rhs_g = blocks.bg - jnp.einsum("pgl,pl->g", WgHinv, blocks.bp)
            Sgc_flat = S_gc.transpose(1, 0, 2).reshape(G, K * C)
            S = jnp.block([[S, Sgc_flat.T], [Sgc_flat, S_gg]])
            rhs = jnp.concatenate([rhs, rhs_g])

        # gauge fixing: zero rows/cols of fixed cameras, identity diagonal
        fixed_v = 1.0 - keep_v
        S = S * keep_v[:, None] * keep_v[None, :] + jnp.diag(fixed_v)
        rhs = rhs * keep_v

        if jacobi:
            d = jnp.sqrt(jnp.maximum(jnp.diag(S), 1e-12))
            dinv = 1.0 / d
            S = S * dinv[:, None] * dinv[None, :]
            rhs = rhs * dinv
        S = S + 1e-6 * jnp.eye(S.shape[0], dtype=S.dtype)
        L = jnp.linalg.cholesky(S)
        y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
        x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
        if jacobi:
            x = x * dinv
        dc = x[:K * C].reshape(K, C)
        dg = x[K * C:] if has_g else None

    elif method == "pcg":
        # SCHUR_JACOBI preconditioner: block diagonal of S (same-observation
        # terms; reference src/optimizer.cpp:161)
        M = Hcc_d - by_cam(jnp.einsum("ocl,odl->ocd", WHinv, blocks.AtB))
        eyeC = jnp.eye(C, dtype=M.dtype)
        M = jnp.where(cam_fixed[:, None, None], eyeC, M)
        M = M + 1e-7 * eyeC

        keep_c = keep[:, None]
        fixed_c = 1.0 - keep_c

        # shared-intrinsics block: only the CAMERA part of the reduced
        # system is kept matrix-free; the global couplings S_gc [K, G, C]
        # and S_gg [G, G] are tiny at any scale (G = 4), so they assemble
        # explicitly — the CG operator is then the exact bordered system
        # [[S, S_gc^T], [S_gc, S_gg]], same math as the explicit path
        # (reference global_BA's variable intrinsics block,
        # src/optimizer.cpp:144-153).
        if has_g:
            Hgg_d = _damp(blocks.Hgg, lam)
            Wg = by_pt(blocks.GtB)                            # [P, G, 3]
            WgHinv = jnp.einsum("pgj,pjl->pgl", Wg, Hpp_inv)  # [P, G, 3]
            S_gg = Hgg_d - jnp.einsum("pgl,phl->gh", WgHinv, Wg) \
                + 1e-7 * jnp.eye(G, dtype=Hgg_d.dtype)
            S_gc = blocks.Hgc - by_cam(
                jnp.einsum("ogl,ocl->ogc", WgHinv[blocks.obs_pt],
                           blocks.AtB))                        # [K, G, C]
            rhs_g = blocks.bg - jnp.einsum("pgl,pl->g", WgHinv, blocks.bp)
        else:
            rhs_g = jnp.zeros((0,), rhs_c.dtype)

        def s_mv(x):
            xc, xg = x
            xk = xc * keep_c
            u = by_pt(jnp.einsum("ocj,oc->oj", blocks.AtB, to_obs(xk)))
            v = jnp.einsum("pij,pj->pi", Hpp_inv, u)
            y = jnp.einsum("kcd,kd->kc", Hcc_d, xk) - by_cam(
                jnp.einsum("ocj,oj->oc", blocks.AtB, v[blocks.obs_pt]))
            if has_g:
                y = y + jnp.einsum("kgc,g->kc", S_gc, xg)
                yg = jnp.einsum("kgc,kc->g", S_gc, xk) \
                    + jnp.einsum("gh,h->g", S_gg, xg)
            else:
                yg = xg
            return y * keep_c + xc * fixed_c, yg

        def m_inv(r):
            rc, rg = r
            zg = chol_solve_small(S_gg, rg) if has_g else rg
            return chol_solve_small(M, rc), zg

        def dot(a, b):
            return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

        b = (rhs_c * keep_c, rhs_g)
        bs = dot(b, b)
        x0 = (jnp.zeros_like(b[0]), jnp.zeros_like(b[1]))
        r0 = b
        z0 = m_inv(r0)
        p0 = z0
        rz0 = dot(r0, z0)

        # termination = two criteria ORed:
        # * residual: ||r||^2 <= cg_tol^2 ||b||^2;
        # * OPTIONAL Q-stagnation (q_eta > 0; Ceres ITERATIVE_SCHUR's
        #   inexact-Newton forcing): the CG quadratic model
        #   Q(x) = 0.5 x'Sx - b'x = -0.5 x'(b + r) stops improving
        #   relative to its value — i*(Q_i - Q_{i-1})/|Q_i| < q_eta.
        # Loose forcing is for BAL-scale solves whose outer LM loop
        # absorbs step inexactness (ba/snavely.py passes q_eta=0.1: exits
        # in ~10 iterations with final LM costs identical to a 1e-5
        # residual solve at ~4x the wall clock). Fixed-budget LM loops
        # that need near-exact steps keep the default q_eta=0.
        def q_of(x, r):
            return -0.5 * (dot(x, b) + dot(x, r))

        def cond(st):
            i, x, r, p, rz, q_prev, q_cur = st
            resid_ok = dot(r, r) > cg_tol**2 * bs
            # Ceres' criterion: Q decreases monotonically, so the per-
            # iteration improvement is q_prev - q_cur >= 0; stop when the
            # projected remaining improvement i*(Q_{i-1} - Q_i) falls below
            # q_eta*|Q_i|. (A previous formulation used q_cur - q_prev <= 0,
            # which is always true — every q_eta>0 solve exited after 2
            # iterations; pinned by test_pcg_q_eta_not_premature.)
            dq = q_prev - q_cur
            stagnant = (q_eta > 0.0) & (i > 1) & \
                (i.astype(q_cur.dtype) * dq <= q_eta * jnp.abs(q_cur))
            return (i < cg_iters) & resid_ok & ~stagnant

        def step(st):
            i, x, r, p, rz, q_prev, q_cur = st
            Ap = s_mv(p)
            alpha = rz / jnp.maximum(dot(p, Ap), 1e-30)
            x = jax.tree.map(lambda xi, pi: xi + alpha * pi, x, p)
            r = jax.tree.map(lambda ri, ai: ri - alpha * ai, r, Ap)
            z = m_inv(r)
            rz_new = dot(r, z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p_new = jax.tree.map(lambda zi, pi: zi + beta * pi, z, p)
            return i + 1, x, r, p_new, rz_new, q_cur, q_of(x, r)

        zero_q = jnp.asarray(0.0, rhs_c.dtype)
        _, (dc, dg), _, _, _, _, _ = jax.lax.while_loop(
            cond, step, (jnp.asarray(0), x0, r0, p0, rz0, zero_q, zero_q))
        if not has_g:
            dg = None
    else:
        raise ValueError(f"unknown schur method {method!r}")

    # back-substitute points: dp = Hpp^-1 (bp - W^T dc - Wg^T dg)
    u = by_pt(jnp.einsum("ocj,oc->oj", blocks.AtB, dc[blocks.obs_cam]))
    if has_g:
        Wg = by_pt(blocks.GtB)
        u = u + jnp.einsum("pgj,g->pj", Wg, dg)
    dp = jnp.einsum("pij,pj->pi", Hpp_inv, blocks.bp - u)
    return dc, dp, dg
