"""Snavely-camera bundle adjustment: the exact BAL objective.

The reference's offline BAL adjuster (tests/ceres/ba.cc:105-118) minimizes
the 9-parameter Snavely model: angle-axis rotation (3), translation (3),
focal f, radial k1, k2 — projection

    p  = R X + t                (camera looks down -z)
    q  = -(p_x, p_y) / p_z
    u  = f * (1 + k1 |q|^2 + k2 |q|^4) * q

This module keeps that parameterization verbatim (no frame flip, no shared
median focal — that lossy conversion lives in io/bal.py for the in-repo
shared-intrinsics pipeline) so costs are directly comparable with Ceres on
real BAL files. Cameras carry a 9-dim tangent: SE3 left retraction on the
pose half, additive on (f, k1, k2).

The solve reuses the observation-keyed Schur core (ba/schur_core.py) — the
camera block dimension is shape-generic, so C=9 flows through the same
explicit / PCG machinery. BAL camera counts routinely exceed the dense-S
comfort zone, so the default solver switches to matrix-free PCG with the
SCHUR_JACOBI preconditioner above ``_EXPLICIT_MAX_CAMS`` cameras.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dr3_tpu.ba.schur_core import (assemble_blocks, check_flat_scatter_size,
                                   solve_schur)
from dr3_tpu.ba.schur_lm import _EXPLICIT_MAX_CAMS
from dr3_tpu.geometry.lie import SE3, hat, quat_rotate, quat_to_matrix, \
    quat_normalize


class SnavelyProblem(NamedTuple):
    cam_wxyz: jnp.ndarray   # [K, 4] world->camera rotations
    cam_t: jnp.ndarray      # [K, 3]
    cam_fkk: jnp.ndarray    # [K, 3] focal, k1, k2
    points: jnp.ndarray     # [P, 3]
    obs_cam: jnp.ndarray    # [O] int32
    obs_pt: jnp.ndarray     # [O] int32
    obs_uv: jnp.ndarray     # [O, 2] BAL pixel measurements
    obs_w: jnp.ndarray      # [O] weight; 0 = padding
    cam_fixed: jnp.ndarray  # [K] bool gauge

    @property
    def n_cams(self) -> int:
        return self.cam_wxyz.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]


class SnavelyResult(NamedTuple):
    problem: SnavelyProblem
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    n_accepted: jnp.ndarray
    lambda_final: jnp.ndarray


def bal_to_snavely(d, dtype=jnp.float32) -> SnavelyProblem:
    """Raw BAL arrays -> SnavelyProblem, parameter-for-parameter (the
    objective is *identical* to tests/ceres/ba.cc's)."""
    from dr3_tpu.geometry.lie import SO3

    aa = jnp.asarray(d.cam_params[:, 0:3], dtype)
    K = d.cam_params.shape[0]
    return SnavelyProblem(
        cam_wxyz=SO3.exp(aa).wxyz.astype(dtype),
        cam_t=jnp.asarray(d.cam_params[:, 3:6], dtype),
        cam_fkk=jnp.asarray(d.cam_params[:, 6:9], dtype),
        points=jnp.asarray(d.points, dtype),
        obs_cam=jnp.asarray(d.obs_cam, jnp.int32),
        obs_pt=jnp.asarray(d.obs_pt, jnp.int32),
        obs_uv=jnp.asarray(d.obs_uv, dtype),
        obs_w=jnp.ones(d.obs_cam.shape[0], dtype),
        cam_fixed=jnp.zeros(K, bool).at[0].set(True),
    )


def snavely_to_bal(p: SnavelyProblem):
    from dr3_tpu.geometry.lie import SO3
    from dr3_tpu.io.bal import BALData

    aa = np.asarray(SO3(p.cam_wxyz).log(), np.float64)
    cam_params = np.concatenate([
        aa, np.asarray(p.cam_t, np.float64),
        np.asarray(p.cam_fkk, np.float64)], axis=1)
    return BALData(cam_params=cam_params,
                   points=np.asarray(p.points, np.float64),
                   obs_cam=np.asarray(p.obs_cam, np.int32),
                   obs_pt=np.asarray(p.obs_pt, np.int32),
                   obs_uv=np.asarray(p.obs_uv, np.float64))


def project_snavely(fkk: jnp.ndarray, xc: jnp.ndarray) -> jnp.ndarray:
    """BAL projection of camera-frame points (ba.cc:105-118): looks down -z,
    u = f * distortion * (-x/z, -y/z)."""
    f, k1, k2 = fkk[..., 0:1], fkk[..., 1:2], fkk[..., 2:3]
    z = xc[..., 2:3]
    z = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    q = -xc[..., :2] / z
    r2 = jnp.sum(q * q, axis=-1, keepdims=True)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    return f * dist * q


class SnavelyResiduals(NamedTuple):
    r: jnp.ndarray    # [O, 2]
    Jc: jnp.ndarray   # [O, 2, 9] d r / d [rho, omega, f, k1, k2]
    Jp: jnp.ndarray   # [O, 2, 3]
    cost: jnp.ndarray
    valid: jnp.ndarray


def residuals_only(p: SnavelyProblem) -> jnp.ndarray:
    q = p.cam_wxyz[p.obs_cam]
    t = p.cam_t[p.obs_cam]
    xc = quat_rotate(q, p.points[p.obs_pt]) + t
    return project_snavely(p.cam_fkk[p.obs_cam], xc) - p.obs_uv


def residual_cost(p: SnavelyProblem, huber_delta: float = 2.0) -> jnp.ndarray:
    """Robust cost WITHOUT Jacobians — the LM accept test only needs the
    cost, and the Jacobian terms are ~60% of linearize's work at BAL
    scale. Validity here is residual-finiteness only (linearize's extra
    Jacobian-finiteness mask re-applies on the next linearization)."""
    quat = p.cam_wxyz[p.obs_cam]
    t = p.cam_t[p.obs_cam]
    fkk = p.cam_fkk[p.obs_cam]
    X = p.points[p.obs_pt]
    xc = quat_rotate(quat, X) + t
    f, k1, k2 = fkk[..., 0], fkk[..., 1], fkk[..., 2]
    z = xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    q2d = -xc[..., :2] / z_safe[..., None]
    r2 = jnp.sum(q2d * q2d, axis=-1)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    r = f[..., None] * dist[..., None] * q2d - p.obs_uv
    valid = jnp.all(jnp.isfinite(r), axis=-1) & (jnp.abs(z) > 1e-9) \
        & (p.obs_w > 0)
    r = jnp.where(valid[..., None], r, 0.0)
    r_norm = jnp.linalg.norm(r, axis=-1)
    rho = jnp.where(r_norm <= huber_delta, 0.5 * r_norm**2,
                    huber_delta * (r_norm - 0.5 * huber_delta))
    return jnp.sum(p.obs_w * valid.astype(r.dtype) * rho)


def linearize(p: SnavelyProblem, huber_delta: float = 2.0) -> SnavelyResiduals:
    """Residuals + analytic Jacobians per observation (9-dim camera blocks)."""
    quat = p.cam_wxyz[p.obs_cam]
    t = p.cam_t[p.obs_cam]
    fkk = p.cam_fkk[p.obs_cam]
    X = p.points[p.obs_pt]
    xc = quat_rotate(quat, X) + t            # [O, 3]

    f, k1, k2 = fkk[..., 0], fkk[..., 1], fkk[..., 2]
    z = xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    inv_z = 1.0 / z_safe
    q2d = -xc[..., :2] * inv_z[..., None]    # [O, 2]
    r2 = jnp.sum(q2d * q2d, axis=-1)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    ddist = k1 + 2.0 * k2 * r2               # d dist / d r2

    uv = f[..., None] * dist[..., None] * q2d
    r = uv - p.obs_uv

    # du/dq = f * (dist * I + 2 ddist * q q^T)   [O, 2, 2]
    eye2 = jnp.eye(2, dtype=xc.dtype)
    du_dq = (f * dist)[..., None, None] * eye2 + \
        (2.0 * f * ddist)[..., None, None] * (q2d[..., :, None] * q2d[..., None, :])

    # dq/dp = -(1/z) * [[1, 0, -x/z], [0, 1, -y/z]]   [O, 2, 3]
    x_z = xc[..., 0] * inv_z
    y_z = xc[..., 1] * inv_z
    one = jnp.ones_like(inv_z)
    zero = jnp.zeros_like(inv_z)
    dq_dp = -inv_z[..., None, None] * jnp.stack([
        jnp.stack([one, zero, -x_z], -1),
        jnp.stack([zero, one, -y_z], -1),
    ], -2)

    du_dp = du_dq @ dq_dp                     # [O, 2, 3]

    # pose block (left retraction): dp/d[rho, omega] = [I | -hat(p)]
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=xc.dtype),
                            xc.shape[:-1] + (3, 3))
    J_pose = du_dp @ jnp.concatenate([eye3, -hat(xc)], axis=-1)  # [O, 2, 6]

    # internal parameters
    du_df = (dist[..., None] * q2d)[..., None]          # [O, 2, 1]
    du_dk1 = (f * r2)[..., None, None] * q2d[..., None]
    du_dk2 = (f * r2 * r2)[..., None, None] * q2d[..., None]
    Jc = jnp.concatenate([J_pose, du_df, du_dk1, du_dk2], axis=-1)  # [O,2,9]

    R = quat_to_matrix(quat_normalize(quat))
    Jp = du_dp @ R

    # Sanitize through the mask with where, not 0-multiplication: padded /
    # non-finite observations can overflow the k2 r^4 term and 0 * inf
    # would nan the summed cost and normal equations (same guard as
    # ba/problem.py linearize).
    valid = jnp.all(jnp.isfinite(r), axis=-1) & (jnp.abs(z) > 1e-9) \
        & (p.obs_w > 0) & jnp.all(jnp.isfinite(Jc), axis=(-2, -1)) \
        & jnp.all(jnp.isfinite(Jp), axis=(-2, -1))
    r = jnp.where(valid[..., None], r, 0.0)
    Jc = jnp.where(valid[..., None, None], Jc, 0.0)
    Jp = jnp.where(valid[..., None, None], Jp, 0.0)
    r_norm = jnp.linalg.norm(r, axis=-1)
    huber_w = jnp.where(r_norm <= huber_delta, 1.0,
                        huber_delta / jnp.maximum(r_norm, 1e-12))
    w = p.obs_w * huber_w * valid.astype(r.dtype)
    sw = jnp.sqrt(w)[..., None]
    rho = jnp.where(r_norm <= huber_delta, 0.5 * r_norm**2,
                    huber_delta * (r_norm - 0.5 * huber_delta))
    cost = jnp.sum(p.obs_w * valid.astype(r.dtype) * rho)
    return SnavelyResiduals(r=r * sw, Jc=Jc * sw[..., None],
                            Jp=Jp * sw[..., None], cost=cost, valid=valid)


def _assemble_direct(p: SnavelyProblem, E: jnp.ndarray, huber_delta: float):
    """Fused linearize + normal-equation assembly, scalarized.

    The generic path (:func:`linearize` + schur_core.assemble_blocks)
    chains batched matmuls over tiny per-observation matrices
    (``[O,2,2] @ [O,2,3]`` etc.) and materializes several rank-3
    ``[O, 2, 9]`` intermediates across the jit boundary between
    linearize and assembly.

    Here every quantity is a plain ``[O]`` vector and the tiny contractions
    (quaternion rotation, du_dq @ dq_dp, the hat-product, du_dp @ R) are
    expanded into elementwise multiply-adds that stream at bandwidth;
    the only materialized per-observation tensors are rank-2 ``[O, F]``
    stacks feeding the camera-one-hot reduction (exact 0/1 matmul) and
    one ``[O, 12]`` point-keyed segment scatter. Same math as
    linearize+assemble_blocks to f32 rounding (pinned by
    tests/test_snavely.py::test_assemble_direct_matches_generic).
    Returns (SchurBlocks, robust cost).
    """
    O = p.n_obs
    K, P = p.n_cams, p.n_points
    oc = jnp.clip(p.obs_cam, 0, K - 1)
    op = jnp.clip(p.obs_pt, 0, P - 1)

    # per-observation camera parameters through ONE [O,K]@[K,10] matmul
    # (exact: E rows are one-hot 0/1), points through one [P,3] gather
    params = jnp.concatenate([p.cam_wxyz, p.cam_t, p.cam_fkk], axis=1)
    po = jax.lax.dot_general(E, params, (((1,), (0,)), ((), ())),
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
    qw, qx_, qy_, qz_ = po[:, 0], po[:, 1], po[:, 2], po[:, 3]
    tx, ty, tz = po[:, 4], po[:, 5], po[:, 6]
    f, k1, k2 = po[:, 7], po[:, 8], po[:, 9]
    X = p.points[op]
    X0, X1, X2 = X[:, 0], X[:, 1], X[:, 2]

    # rotation matrix entries from the (normalized) quaternion
    qn = jax.lax.rsqrt(jnp.maximum(qw * qw + qx_ * qx_ + qy_ * qy_
                                   + qz_ * qz_, 1e-24))
    w, x, y, z_ = qw * qn, qx_ * qn, qy_ * qn, qz_ * qn
    R00 = 1.0 - 2.0 * (y * y + z_ * z_)
    R01 = 2.0 * (x * y - w * z_)
    R02 = 2.0 * (x * z_ + w * y)
    R10 = 2.0 * (x * y + w * z_)
    R11 = 1.0 - 2.0 * (x * x + z_ * z_)
    R12 = 2.0 * (y * z_ - w * x)
    R20 = 2.0 * (x * z_ - w * y)
    R21 = 2.0 * (y * z_ + w * x)
    R22 = 1.0 - 2.0 * (x * x + y * y)

    xc0 = R00 * X0 + R01 * X1 + R02 * X2 + tx
    xc1 = R10 * X0 + R11 * X1 + R12 * X2 + ty
    xc2 = R20 * X0 + R21 * X1 + R22 * X2 + tz

    z_safe = jnp.where(jnp.abs(xc2) < 1e-12, 1e-12, xc2)
    iz = 1.0 / z_safe
    qx = -xc0 * iz
    qy = -xc1 * iz
    r2 = qx * qx + qy * qy
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    ddist = k1 + 2.0 * k2 * r2

    uo, vo = p.obs_uv[:, 0], p.obs_uv[:, 1]
    fd = f * dist
    ru = fd * qx - uo
    rv = fd * qy - vo

    # du/dq = f*dist*I + 2 f ddist q q^T (2x2 symmetric)
    B = 2.0 * f * ddist
    d11 = fd + B * qx * qx
    d12 = B * qx * qy
    d22 = fd + B * qy * qy

    # du/dp = du_dq @ dq_dp with dq_dp = [[-iz,0,-iz*qx],[0,-iz,-iz*qy]]
    M00 = -iz * d11
    M01 = -iz * d12
    M02 = -iz * (d11 * qx + d12 * qy)
    M10 = -iz * d12
    M11 = -iz * d22
    M12 = -iz * (d12 * qx + d22 * qy)

    # pose block: [du_dp | -du_dp @ hat(xc)]
    def rot_cols(a, b, c):
        return (b * xc2 - c * xc1, c * xc0 - a * xc2, a * xc1 - b * xc0)

    W03, W04, W05 = rot_cols(M00, M01, M02)
    W13, W14, W15 = rot_cols(M10, M11, M12)

    # internal parameters
    Jf_u = dist * qx
    Jf_v = dist * qy
    Jk1_u = f * r2 * qx
    Jk1_v = f * r2 * qy
    Jk2_u = f * r2 * r2 * qx
    Jk2_v = f * r2 * r2 * qy

    Jc_u = (M00, M01, M02, -W03, -W04, -W05, Jf_u, Jk1_u, Jk2_u)
    Jc_v = (M10, M11, M12, -W13, -W14, -W15, Jf_v, Jk1_v, Jk2_v)

    # Jp = du_dp @ R
    Jp_u = (M00 * R00 + M01 * R10 + M02 * R20,
            M00 * R01 + M01 * R11 + M02 * R21,
            M00 * R02 + M01 * R12 + M02 * R22)
    Jp_v = (M10 * R00 + M11 * R10 + M12 * R20,
            M10 * R01 + M11 * R11 + M12 * R21,
            M10 * R02 + M11 * R12 + M12 * R22)

    fin = jnp.isfinite(ru) & jnp.isfinite(rv)
    for col in Jc_u + Jc_v + Jp_u + Jp_v:
        fin = fin & jnp.isfinite(col)
    valid = fin & (jnp.abs(xc2) > 1e-9) & (p.obs_w > 0)

    # sanitize through the mask with where, not 0-multiplication: padded /
    # non-finite observations can overflow the k2 r^4 term and 0 * inf
    # would nan the summed cost and normal equations (same guard as
    # linearize)
    vf = valid.astype(ru.dtype)
    ru = jnp.where(valid, ru, 0.0)
    rv = jnp.where(valid, rv, 0.0)
    r_norm = jnp.sqrt(ru * ru + rv * rv)
    huber_w = jnp.where(r_norm <= huber_delta, 1.0,
                        huber_delta / jnp.maximum(r_norm, 1e-12))
    wgt = p.obs_w * huber_w * vf
    sw = jnp.sqrt(wgt)
    rho = jnp.where(r_norm <= huber_delta, 0.5 * r_norm * r_norm,
                    huber_delta * (r_norm - 0.5 * huber_delta))
    cost = jnp.sum(p.obs_w * vf * rho)

    ru = ru * sw
    rv = rv * sw
    Jc_u = tuple(jnp.where(valid, c, 0.0) * sw for c in Jc_u)
    Jc_v = tuple(jnp.where(valid, c, 0.0) * sw for c in Jc_v)
    Jp_u = tuple(jnp.where(valid, c, 0.0) * sw for c in Jp_u)
    Jp_v = tuple(jnp.where(valid, c, 0.0) * sw for c in Jp_v)

    # ---- normal-equation blocks ----
    # Two rank-2 product stacks: [O, 90] camera-keyed (AtA | Atr) reduced
    # through ONE exact one-hot matmul, and [O, 12] point-keyed
    # (BtB | Btr) through one segment scatter. The coupling W = Jc^T Jp is
    # NEVER materialized: the solves consume the factored J columns
    # directly (every AtB product is rank-2 through the residual space),
    # which keeps all per-observation tensors out of padded rank-3
    # layouts.
    feats = [Jc_u[i] * Jc_u[j] + Jc_v[i] * Jc_v[j]
             for i in range(9) for j in range(9)]               # AtA flat
    feats += [Jc_u[i] * ru + Jc_v[i] * rv for i in range(9)]    # Atr
    cam_stack = jnp.stack(feats, axis=-1)                       # [O, 90]

    red = jax.lax.dot_general(E, cam_stack, (((0,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)  # [K, 90]
    Hcc = red[:, :81].reshape(K, 9, 9)
    bc = -red[:, 81:90]

    pt_feats = [Jp_u[i] * Jp_u[j] + Jp_v[i] * Jp_v[j]
                for i in range(3) for j in range(3)]            # BtB flat
    pt_feats += [Jp_u[i] * ru + Jp_v[i] * rv for i in range(3)]  # Btr
    pred = jax.ops.segment_sum(jnp.stack(pt_feats, axis=-1), op,
                               num_segments=P)                  # [P, 12]
    Hpp9 = pred[:, :9]                                          # [P, 9]
    bp = -pred[:, 9:12]

    return DirectBlocks(Hcc=Hcc, bc=bc, Hpp9=Hpp9, bp=bp,
                        Jcu=Jc_u, Jcv=Jc_v, Jpu=Jp_u, Jpv=Jp_v,
                        obs_cam=oc, obs_pt=op, active=valid), cost


class DirectBlocks(NamedTuple):
    """Rank-2 normal-equation blocks for the scalarized BAL fast path.

    The camera-point coupling W = Jc^T Jp is carried FACTORED as the
    weighted Jacobian columns (tuples of [O] vectors, u/v residual rows):
    every product the solves need contracts through the 2-dim residual
    space, e.g. (W x)_o = Jp^T (Jc x)_o with (Jc x) just two [O] scalars
    — so no [O, 27] coupling array (let alone a padded rank-3 one) is
    ever materialized."""

    Hcc: jnp.ndarray     # [K, 9, 9]
    bc: jnp.ndarray      # [K, 9]
    Hpp9: jnp.ndarray    # [P, 9] row-major 3x3 blocks
    bp: jnp.ndarray      # [P, 3]
    Jcu: tuple           # 9 x [O] camera-Jacobian columns, u row
    Jcv: tuple           # 9 x [O], v row
    Jpu: tuple           # 3 x [O] point-Jacobian columns, u row
    Jpv: tuple           # 3 x [O], v row
    obs_cam: jnp.ndarray
    obs_pt: jnp.ndarray
    active: jnp.ndarray


def _inv3x3_flat(h9, lam):
    """Damped inverse of symmetric 3x3 blocks stored as [P, 9] columns —
    scalarized adjugate/determinant (no [P, 3, 3] rank-3 arrays).

    Each block is normalized by its max |entry| first: real-structure
    Hpp blocks reach ~1e13, whose raw determinant (~|H|^3 > 3.4e38)
    overflows f32 to inf - inf = NaN — which then silently rejected
    EVERY LM step through the finite-parameter guard (round-5 chip
    debugging on the exported 221-camera problem). inv(H) = inv(H/s)/s.
    """
    a = h9[:, 0] * (1.0 + lam) + 1e-8
    e = h9[:, 4] * (1.0 + lam) + 1e-8
    i = h9[:, 8] * (1.0 + lam) + 1e-8
    b, c, f = h9[:, 1], h9[:, 2], h9[:, 5]
    d, g, h = h9[:, 3], h9[:, 6], h9[:, 7]
    scale = jnp.maximum(
        jnp.max(jnp.abs(jnp.stack([a, b, c, d, e, f, g, h, i], axis=-1)),
                axis=-1), 1e-30)
    inv_s = 1.0 / scale
    a, b, c = a * inv_s, b * inv_s, c * inv_s
    d, e, f = d * inv_s, e * inv_s, f * inv_s
    g, h, i = g * inv_s, h * inv_s, i * inv_s
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = inv_s / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    cols = [A00, A01, A02, A10, A11, A12, A20, A21, A22]
    return jnp.stack([x * inv_det for x in cols], axis=-1)    # [P, 9]


def _mv3(h9, x):
    """[P, 9] flat 3x3 blocks times [P, 3] vectors -> [P, 3]."""
    return jnp.stack([
        h9[:, 0] * x[:, 0] + h9[:, 1] * x[:, 1] + h9[:, 2] * x[:, 2],
        h9[:, 3] * x[:, 0] + h9[:, 4] * x[:, 1] + h9[:, 5] * x[:, 2],
        h9[:, 6] * x[:, 0] + h9[:, 7] * x[:, 1] + h9[:, 8] * x[:, 2],
    ], axis=-1)


def _chol3_flat(h9):
    """Lower Cholesky factor of SPD 3x3 blocks stored flat [P, 9] ->
    [P, 6] columns (l00, l10, l11, l20, l21, l22), scalarized."""
    a, b, c = h9[:, 0], h9[:, 1], h9[:, 2]
    e, f, i = h9[:, 4], h9[:, 5], h9[:, 8]
    l00 = jnp.sqrt(jnp.maximum(a, 1e-30))
    l10 = b / l00
    l20 = c / l00
    l11 = jnp.sqrt(jnp.maximum(e - l10 * l10, 1e-30))
    l21 = (f - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(i - l20 * l20 - l21 * l21, 1e-30))
    return jnp.stack([l00, l10, l11, l20, l21, l22], axis=-1)


# dense-Z ceiling: the [3P, 9K] square-root factor of the Schur correction
# must fit comfortably in HBM (f32)
_Z_MAX_BYTES = 2 * 1024**3


def _solve_explicit_direct(blocks: "DirectBlocks", lam, cam_fixed, E):
    """EXACT dense Schur solve via a square-root factorization — the
    BAL-scale fast path that replaces the CG loop entirely.

    The cross-camera correction is sum_p W_p Hpp^-1 W_p^T with
    W never materialized. Write Hpp^-1_p = L_p L_p^T (3x3 Cholesky) and
    per observation Z_o = L_{p(o)}^T Jp_o^T Jc_o in R^{3x9}; then

        sum_p W Hpp^-1 W^T  =  Z^T Z,   Z in R^{3P x 9K},

    where Z's (3p+r, 9k+c) block row collects the unique observation of
    point p by camera k (a camera observes a point at most once, so the
    scatter that builds dense Z has no collisions). Z^T Z is ONE matmul
    (~420 GFLOP at 120 cams x 60k points) and the reduced [9K, 9K] system
    solves by Cholesky — instead of ~20 PCG iterations each paying a
    point-keyed scatter+gather. Dense Z costs
    12*P*K*9 bytes; callers fall back to PCG above ``_Z_MAX_BYTES``.
    Same reduced system as schur_core.solve_schur(method='explicit')
    (pinned by tests/test_snavely.py::test_solve_explicit_direct_matches).
    """
    K = blocks.Hcc.shape[0]
    P = blocks.Hpp9.shape[0]
    op = blocks.obs_pt
    oc = blocks.obs_cam
    Jcu, Jcv = blocks.Jcu, blocks.Jcv
    Jpu, Jpv = blocks.Jpu, blocks.Jpv
    O = Jcu[0].shape[0]
    dtype = Jcu[0].dtype

    eye9 = jnp.eye(9, dtype=dtype)
    diag_c = jnp.diagonal(blocks.Hcc, axis1=-2, axis2=-1)
    Hcc_d = blocks.Hcc + eye9 * (lam * diag_c + 1e-8)[..., None, :]
    Hinv9 = _inv3x3_flat(blocks.Hpp9, lam)              # [P, 9]
    L6 = _chol3_flat(Hinv9)                             # [P, 6]

    Lo = L6[op]                                         # [O, 6] one gather
    # Z_o = L^T (Jp^T Jc)_o: with AtB[c, j] = Jcu_c Jpu_j + Jcv_c Jpv_j,
    # Z[r, c] = sum_j L[j, r] AtB[c, j] = Jcu_c * au_r + Jcv_c * av_r
    # where au_r = sum_j L[j, r] Jpu_j — the coupling factors through the
    # 2-dim residual space, so Z builds from 6 precombined [O] vectors.
    # L (lower) columns: L[:,0]=(l00,l10,l20), L[:,1]=(0,l11,l21),
    # L[:,2]=(0,0,l22)
    l = [Lo[:, 0], Lo[:, 1], Lo[:, 2], Lo[:, 3], Lo[:, 4], Lo[:, 5]]
    au = (l[0] * Jpu[0] + l[1] * Jpu[1] + l[3] * Jpu[2],
          l[2] * Jpu[1] + l[4] * Jpu[2],
          l[5] * Jpu[2])
    av = (l[0] * Jpv[0] + l[1] * Jpv[1] + l[3] * Jpv[2],
          l[2] * Jpv[1] + l[4] * Jpv[2],
          l[5] * Jpv[2])
    zupd = jnp.stack([Jcu[c] * au[r] + Jcv[c] * av[r]
                      for r in range(3) for c in range(9)],
                     axis=-1)                           # [O, 27]

    check_flat_scatter_size(3 * P * 9 * K)
    rows = 3 * op[:, None] + jnp.arange(3, dtype=op.dtype)[None, :]
    cols = 9 * oc[:, None] + jnp.arange(9, dtype=oc.dtype)[None, :]
    flat_idx = (rows[:, :, None] * (9 * K) + cols[:, None, :]).reshape(O, 27)
    # indices are in bounds by construction (clipped obs ids); must stay
    # an ADD, not a unique-set: zero-weight padding rows carry clipped
    # (cam, point) ids that can collide with real observations — their
    # zupd values are exactly 0, so accumulation is always safe
    Z = jnp.zeros((3 * P * 9 * K,), dtype) \
        .at[flat_idx.reshape(-1)].add(zupd.reshape(-1),
                                      mode="promise_in_bounds") \
        .reshape(3 * P, 9 * K)

    # Jacobi scaling applied BEFORE the big matmul: normalize Z's columns
    # by sqrt(diag S) so S~ = D^-1/2 (Hcc_d - Z^T Z) D^-1/2 accumulates in
    # f32 with O(eps) ABSOLUTE error — scaling after the matmul commits
    # ~|S| * eps errors first, which on real-structure problems (diag
    # spreads ~1e14) destroyed PSD-ness and made the factorization NaN at
    # small lambda (round-5 chip debugging). diag(S) comes cheaply from
    # Hcc_d's diagonal minus Z's column norms.
    hdiag = jnp.diagonal(Hcc_d, axis1=-2, axis2=-1).reshape(9 * K)
    colsq = jnp.sum(Z * Z, axis=0)
    sdiag = jnp.maximum(hdiag - colsq, 1e-10 * jnp.maximum(hdiag, 1e-20))
    dinv = jax.lax.rsqrt(sdiag)
    Zs = Z * dinv[None, :]
    d2 = dinv.reshape(K, 9)
    Hs = Hcc_d * (d2[:, :, None] * d2[:, None, :])
    S = -jax.lax.dot_general(Zs, Zs, (((0,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    S = S.reshape(K, 9, K, 9).at[jnp.arange(K), :, jnp.arange(K), :] \
        .add(Hs).reshape(9 * K, 9 * K)

    # rhs_c = bc - by_cam(Jc^T Jp Hinv bp), factored through the 2-vector
    # t = Jp Hinv bp per observation
    bp_o = _mv3(Hinv9, blocks.bp)[op]                   # [O, 3] one gather
    tu = Jpu[0] * bp_o[:, 0] + Jpu[1] * bp_o[:, 1] + Jpu[2] * bp_o[:, 2]
    tv = Jpv[0] * bp_o[:, 0] + Jpv[1] * bp_o[:, 1] + Jpv[2] * bp_o[:, 2]
    su = jnp.stack([Jcu[c] * tu + Jcv[c] * tv for c in range(9)],
                   axis=-1)                             # [O, 9] = W Hinv bp
    rhs_c = blocks.bc - jax.lax.dot_general(
        E, su, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)

    keep_v = jnp.repeat((~cam_fixed).astype(S.dtype), 9)
    fixed_v = 1.0 - keep_v
    S = S * keep_v[:, None] * keep_v[None, :] + jnp.diag(fixed_v)
    rhs = rhs_c.reshape(9 * K) * dinv * keep_v
    S = S + 1e-6 * jnp.eye(S.shape[0], dtype=S.dtype)
    # the system is pre-scaled (diag ~1), so the f32 Cholesky is safe;
    # residual pathologies (a camera with zero live observations at tiny
    # lambda) become a rejected zero step via the NaN guard instead of
    # poisoning the LM loop
    Lc = jnp.linalg.cholesky(S)
    y = jax.scipy.linalg.solve_triangular(Lc, rhs, lower=True)
    xs = jax.scipy.linalg.solve_triangular(Lc.T, y, lower=False)
    xs = jnp.where(jnp.isfinite(xs), xs, 0.0)
    dc = (xs * dinv).reshape(K, 9)

    # back-substitute points: dp = Hinv (bp - W^T dc), factored:
    # (W^T dc)_o = Jp^T (Jc dc)_o with (Jc dc) two [O] scalars
    dco = jax.lax.dot_general(E, dc * (~cam_fixed)[:, None].astype(dtype),
                              (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)  # [O, 9]
    su2 = sum(Jcu[c] * dco[:, c] for c in range(9))
    sv2 = sum(Jcv[c] * dco[:, c] for c in range(9))
    u = jnp.stack([Jpu[ll] * su2 + Jpv[ll] * sv2 for ll in range(3)],
                  axis=-1)
    up = jax.ops.segment_sum(u, op, num_segments=P)
    dp = _mv3(Hinv9, blocks.bp - up)
    return dc, dp


def _solve_pcg_direct(blocks: "DirectBlocks", lam, cam_fixed, E,
                      cg_iters: int, cg_tol: float, q_eta: float):
    """Matrix-free Schur PCG on rank-2 blocks (the scalarized twin of
    schur_core.solve_schur's pcg path — same math, same SCHUR_JACOBI
    preconditioner, same residual + Ceres Q-stagnation termination;
    equivalence pinned by tests/test_snavely.py). Every per-observation
    quantity stays [O, F<=27] rank-2; camera reductions/broadcasts are
    exact one-hot matmuls against ``E``; the only per-CG-iteration
    point ops are one [O, 3] segment scatter and one [P, 3] gather."""
    from dr3_tpu.geometry.linalg import chol_solve_small

    K = blocks.Hcc.shape[0]
    P = blocks.Hpp9.shape[0]
    op = blocks.obs_pt
    Jcu, Jcv = blocks.Jcu, blocks.Jcv
    Jpu, Jpv = blocks.Jpu, blocks.Jpv
    dtype = Jcu[0].dtype

    eye9 = jnp.eye(9, dtype=dtype)
    diag_c = jnp.diagonal(blocks.Hcc, axis1=-2, axis2=-1)
    Hcc_d = blocks.Hcc + eye9 * (lam * diag_c + 1e-8)[..., None, :]
    Hinv9 = _inv3x3_flat(blocks.Hpp9, lam)              # [P, 9]

    def by_cam(stack):
        return jax.lax.dot_general(E, stack, (((0,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST,
                                   preferred_element_type=jnp.float32)

    def to_obs(per_cam):
        return jax.lax.dot_general(E, per_cam, (((1,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST,
                                   preferred_element_type=jnp.float32)

    # rhs_c = bc - by_cam(W Hinv bp), factored through t = Jp (Hinv bp)
    bp_o = _mv3(Hinv9, blocks.bp)[op]                   # [O, 3] one gather
    tu = Jpu[0] * bp_o[:, 0] + Jpu[1] * bp_o[:, 1] + Jpu[2] * bp_o[:, 2]
    tv = Jpv[0] * bp_o[:, 0] + Jpv[1] * bp_o[:, 1] + Jpv[2] * bp_o[:, 2]
    rhs_o = jnp.stack([Jcu[c] * tu + Jcv[c] * tv for c in range(9)],
                      axis=-1)                          # [O, 9]
    rhs_c = blocks.bc - by_cam(rhs_o)

    # SCHUR_JACOBI preconditioner: block diagonal of S. Per observation
    # AtB Hinv AtB^T = Jc^T (Jp Hinv Jp^T) Jc with the middle a 2x2
    # (a b; b g2) of [O] scalars.
    Hio = Hinv9[op]                                     # [O, 9] one gather
    hu = [sum(Jpu[j] * Hio[:, 3 * j + l] for j in range(3))
          for l in range(3)]
    hv = [sum(Jpv[j] * Hio[:, 3 * j + l] for j in range(3))
          for l in range(3)]
    a2 = sum(hu[l] * Jpu[l] for l in range(3))
    b2 = sum(hu[l] * Jpv[l] for l in range(3))
    g2 = sum(hv[l] * Jpv[l] for l in range(3))
    mm = jnp.stack([
        a2 * Jcu[i] * Jcu[k] + b2 * (Jcu[i] * Jcv[k] + Jcv[i] * Jcu[k])
        + g2 * Jcv[i] * Jcv[k]
        for i in range(9) for k in range(9)], axis=-1)  # [O, 81]
    M = Hcc_d - by_cam(mm).reshape(K, 9, 9)
    eyeC = jnp.eye(9, dtype=M.dtype)
    M = jnp.where(cam_fixed[:, None, None], eyeC, M) + 1e-7 * eyeC

    keep = (~cam_fixed).astype(dtype)[:, None]          # [K, 1]
    fixed_c = 1.0 - keep

    def s_mv(xc):
        xk = xc * keep
        xo = to_obs(xk)                                 # [O, 9]
        su = sum(Jcu[c] * xo[:, c] for c in range(9))
        sv = sum(Jcv[c] * xo[:, c] for c in range(9))
        u = jnp.stack([Jpu[l] * su + Jpv[l] * sv for l in range(3)],
                      axis=-1)                          # [O, 3]
        up = jax.ops.segment_sum(u, op, num_segments=P)  # [P, 3] scatter
        v = _mv3(Hinv9, up)
        vo = v[op]                                      # [O, 3] gather
        tu2 = sum(Jpu[l] * vo[:, l] for l in range(3))
        tv2 = sum(Jpv[l] * vo[:, l] for l in range(3))
        yo = jnp.stack([Jcu[c] * tu2 + Jcv[c] * tv2 for c in range(9)],
                       axis=-1)                         # [O, 9]
        y = jnp.einsum("kcd,kd->kc", Hcc_d, xk) - by_cam(yo)
        return y * keep + xc * fixed_c

    def m_inv(r):
        return chol_solve_small(M, r)

    def dot(a, b):
        return jnp.sum(a * b)

    # solve in a normalized scale: |rhs| entries reach ~1e8 on real
    # problems and dot(b, b) then overflows f32 to inf, which makes the
    # very first CG residual check (|r|^2 > tol^2 |b|^2 -> inf > inf)
    # false — the loop exits with a silent zero camera step (observed
    # round 5 on chip). CG is linear, so solve S x' = b/s and rescale.
    b_raw = rhs_c * keep
    s_b = jnp.maximum(jnp.max(jnp.abs(b_raw)), 1e-30)
    b = b_raw / s_b
    bs = dot(b, b)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = m_inv(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    def q_of(x, r):
        return -0.5 * (dot(x, b) + dot(x, r))

    def cond(st):
        i, x, r, p, rz, q_prev, q_cur = st
        resid_ok = dot(r, r) > cg_tol**2 * bs
        dq = q_prev - q_cur
        stagnant = (q_eta > 0.0) & (i > 1) & \
            (i.astype(q_cur.dtype) * dq <= q_eta * jnp.abs(q_cur))
        return (i < cg_iters) & resid_ok & ~stagnant

    def step(st):
        i, x, r, p, rz, q_prev, q_cur = st
        Ap = s_mv(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = m_inv(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        return i + 1, x, r, z + beta * p, rz_new, q_cur, q_of(x, r)

    zero_q = jnp.asarray(0.0, b.dtype)
    _, dc, _, _, _, _, _ = jax.lax.while_loop(
        cond, step, (jnp.asarray(0), x0, r0, p0, rz0, zero_q, zero_q))
    dc = dc * s_b                                       # undo the b scaling
    dc = jnp.where(jnp.isfinite(dc), dc, 0.0)

    # back-substitute points (factored as in s_mv)
    dco = to_obs(dc * keep)                             # [O, 9]
    su3 = sum(Jcu[c] * dco[:, c] for c in range(9))
    sv3 = sum(Jcv[c] * dco[:, c] for c in range(9))
    u = jnp.stack([Jpu[l] * su3 + Jpv[l] * sv3 for l in range(3)],
                  axis=-1)
    up = jax.ops.segment_sum(u, op, num_segments=P)
    dp = _mv3(Hinv9, blocks.bp - up)
    return dc, dp


def apply_update(p: SnavelyProblem, dc: jnp.ndarray,
                 dp: jnp.ndarray) -> SnavelyProblem:
    """dc [K, 9] = [rho, omega, df, dk1, dk2]; fixed cameras stay put."""
    dc = jnp.where(p.cam_fixed[:, None], 0.0, dc)
    new_cams = SE3.exp(dc[:, :6]) @ SE3(p.cam_wxyz, p.cam_t)
    new_cams = new_cams.normalize()
    return p._replace(cam_wxyz=new_cams.wxyz, cam_t=new_cams.t,
                      cam_fkk=p.cam_fkk + dc[:, 6:],
                      points=p.points + dp)


@functools.partial(jax.jit, static_argnums=(1, 2, 4, 5, 6, 7, 8))
def bundle_adjust_snavely(problem: SnavelyProblem, max_iters: int = 30,
                          huber_delta: float = 2.0, lambda0: float = 1e-3,
                          solver: str = "auto", d_max: int | None = None,
                          cg_iters: int = 100, cg_tol: float = 1e-2,
                          q_eta: float = 0.1) -> SnavelyResult:
    """LM on the exact BAL objective (ba.cc's ceres::Solve equivalent).

    ``cg_tol``/``q_eta`` control the PCG inner solve (defaults: the loose
    Ceres ITERATIVE_SCHUR forcing, right for BAL-scale problems whose outer
    LM loop absorbs step inexactness). Callers that need near-exact steps —
    fixed LM budgets, tight-convergence tests — pass cg_tol=1e-5, q_eta=0.
    """
    # camera one-hot for matmul-shaped parameter broadcasts + normal-equation
    # reductions, built ONCE and reused every LM iteration (obs_cam is
    # constant across the loop). Above ~1 GB of one-hot fall back to the
    # generic gather/scatter path.
    use_direct = problem.n_obs * problem.n_cams <= 256 * 1024 * 1024
    z_fits = (12 * problem.n_points * problem.n_cams * 9 <= _Z_MAX_BYTES)

    method = solver
    if solver == "auto":
        # the square-root dense-Schur fast path is both exact AND the
        # cheapest at BAL scale (no CG loop; one matmul) — prefer it
        # whenever dense Z fits, fall back to matrix-free PCG beyond
        if use_direct and z_fits:
            method = "zexplicit"
        elif problem.n_cams <= _EXPLICIT_MAX_CAMS:
            method = "explicit"
        else:
            method = "pcg"
    if method == "zexplicit" and not (use_direct and z_fits):
        method = "pcg"
    if d_max is None:
        d_max = min(problem.n_cams, problem.n_obs)
    cost0 = residual_cost(problem, huber_delta)

    E = None
    if use_direct:
        from dr3_tpu.ba.schur_core import cam_onehot_matrix

        E = cam_onehot_matrix(problem.obs_cam, problem.n_cams)

    fast = use_direct and method in ("pcg", "zexplicit")

    def body(_, state):
        p, lam, best_cost, n_acc = state
        # loose inexact-Newton forcing (Ceres ITERATIVE_SCHUR eta): at BAL
        # scale the LM loop absorbs CG step inexactness, so the Q-stagnation
        # exit cuts ~90 CG iterations per LM step at identical final cost
        if fast:
            # fused scalarized linearize+assembly+solve — the BAL-scale
            # fast path (see _assemble_direct / _solve_explicit_direct /
            # _solve_pcg_direct)
            blocks, _c = _assemble_direct(p, E, huber_delta)
            if method == "zexplicit":
                dc, dpt = _solve_explicit_direct(blocks, lam, p.cam_fixed, E)
            else:
                dc, dpt = _solve_pcg_direct(blocks, lam, p.cam_fixed, E,
                                            cg_iters, cg_tol, q_eta)
        else:
            res = linearize(p, huber_delta)
            active = (p.obs_w > 0) & res.valid
            blocks = assemble_blocks(res.r, res.Jc, res.Jp, p.obs_cam,
                                     p.obs_pt, active, p.n_cams,
                                     p.n_points, cam_onehot=E)
            dc, dpt, _ = solve_schur(blocks, lam, p.cam_fixed, method=method,
                                     d_max=d_max, cg_iters=cg_iters,
                                     cg_tol=cg_tol, q_eta=q_eta)
        p_new = apply_update(p, dc, dpt)
        new_cost = residual_cost(p_new, huber_delta)
        # finite params required: a nan candidate masks its own
        # observations, making its cost spuriously small (ba/schur_lm.py)
        finite = (jnp.all(jnp.isfinite(p_new.cam_wxyz))
                  & jnp.all(jnp.isfinite(p_new.cam_t))
                  & jnp.all(jnp.isfinite(p_new.cam_fkk))
                  & jnp.all(jnp.isfinite(p_new.points)))
        ok = (new_cost < best_cost) & jnp.isfinite(new_cost) & finite
        p_next = jax.tree.map(lambda a, b: jnp.where(ok, b, a), p, p_new)
        lam_next = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                             jnp.minimum(lam * 2.0, 1e6))
        best = jnp.where(ok, new_cost, best_cost)
        return p_next, lam_next, best, n_acc + ok.astype(jnp.int32)

    init = (problem, jnp.asarray(lambda0, jnp.float32), cost0,
            jnp.asarray(0, jnp.int32))
    p_fin, lam_fin, cost_fin, n_acc = jax.lax.fori_loop(0, max_iters, body,
                                                        init)
    return SnavelyResult(problem=p_fin, initial_cost=cost0,
                         final_cost=cost_fin, n_accepted=n_acc,
                         lambda_final=lam_fin)
