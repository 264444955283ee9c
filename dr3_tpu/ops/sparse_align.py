"""Sparse image alignment (SVO-style direct pose tracking).

The reference registers a "sparse_img_align" stage timer (reference
src/handler.cpp:22-26) for the SVO tracking design it never implemented
(process_frame is an empty stub, src/handler.cpp:80-82). This module builds
that stage: estimate the current camera pose by direct photometric
alignment of small patches around mapped features, before any feature
matching — which makes tracking robust to larger inter-frame motion than
LK-with-identity-init alone.

Formulation (inverse-compositional on SE3):
  minimize_T  sum_i || I_cur( pi( T X_i ) + u ) - P_i(u) ||^2
over patches P_i sampled in the reference frame around each feature. The
Jacobian chain d r / d tangent = dI/du * dpi/dXc * dXc/dT uses reference-
patch gradients (constant across iterations), so each GN iteration is one
batched bilinear gather + two reductions — the same fixed-iteration masked
pattern as ops/lk.py, batched over all features, jit-friendly.

Operates at a coarse pyramid level (cheap, large convergence basin); the
refined pose then seeds LK + the reprojection optimizer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dr3_tpu.geometry.lie import SE3, hat
from dr3_tpu.geometry.linalg import chol_solve_small
from dr3_tpu.models.camera import Pinhole
from dr3_tpu.ops.warp import bilinear_sample


class AlignResult(NamedTuple):
    T: SE3               # refined world->camera pose
    cost0: jnp.ndarray   # initial photometric cost
    cost: jnp.ndarray    # final photometric cost
    n_used: jnp.ndarray  # features contributing


def _patch_grid(half: int, dtype=jnp.float32):
    off = jnp.arange(-half, half + 1, dtype=dtype)
    oy, ox = jnp.meshgrid(off, off, indexing="ij")
    return jnp.stack([ox, oy], axis=-1)  # [P, P, 2]


def _sample_patches(img, centers, half):
    """[N, 2] centers -> [N, W, W] bilinear patches, clamp borders."""
    coords = centers[:, None, None, :] + _patch_grid(half)[None]
    return bilinear_sample(img, coords, clamp=True)[0]


def sparse_align(img_ref: jnp.ndarray, img_cur: jnp.ndarray,
                 T_ref: SE3, T_init: SE3, cam: Pinhole,
                 points_w: jnp.ndarray, valid: jnp.ndarray,
                 level: int = 2, half_patch: int = 2,
                 iters: int = 15) -> AlignResult:
    """Refine T_init (world->cur) against img_ref patches.

    img_ref/img_cur: pyramid images at ``level``; points_w [N, 3] world
    landmarks visible in the reference frame; valid [N]. Intrinsics are
    scaled internally to the pyramid level.
    """
    scale = 1.0 / (2.0 ** level)
    fx, fy = cam.fx * scale, cam.fy * scale
    cx_, cy_ = cam.cx * scale, cam.cy * scale

    def project(xc):
        z = jnp.where(jnp.abs(xc[..., 2:3]) < 1e-9, 1e-9, xc[..., 2:3])
        xy = xc[..., :2] / z
        return jnp.stack([fx * xy[..., 0] + cx_, fy * xy[..., 1] + cy_], -1)

    # reference patches + gradients at the landmarks' reference projections:
    # ONE (half+1)-patch sample yields the center patch AND both central-
    # difference gradients (identical numerics to sampling at ±1 px — the
    # sample grid is integer offsets of the same fractional position)
    xc_ref = T_ref.apply(points_w)
    uv_ref = project(xc_ref)
    P_big = _sample_patches(img_ref, uv_ref, half_patch + 1)  # [N, W+2, W+2]
    P_ref = P_big[:, 1:-1, 1:-1]
    gx = (P_big[:, 1:-1, 2:] - P_big[:, 1:-1, :-2]) * 0.5
    gy = (P_big[:, 2:, 1:-1] - P_big[:, :-2, 1:-1]) * 0.5

    h_ref, w_ref = img_ref.shape
    m = float(half_patch)
    ref_in = (uv_ref[:, 0] >= m) & (uv_ref[:, 0] <= w_ref - 1 - m) \
        & (uv_ref[:, 1] >= m) & (uv_ref[:, 1] <= h_ref - 1 - m)
    use = valid & (xc_ref[..., 2] > 1e-3) & ref_in
    w = use.astype(jnp.float32)

    def residual_system(T: SE3):
        """Return (H [6,6], b [6], cost) for the current pose estimate."""
        xc = T.apply(points_w)                   # [N, 3]
        uv = project(xc)
        I = _sample_patches(img_cur, uv, half_patch)
        r = (I - P_ref)                           # [N, P, P]
        in_front = (xc[..., 2] > 1e-3)
        wi = w * in_front.astype(jnp.float32)

        z = jnp.where(jnp.abs(xc[..., 2]) < 1e-9, 1e-9, xc[..., 2])
        inv_z = 1.0 / z
        x_z = xc[..., 0] * inv_z
        y_z = xc[..., 1] * inv_z
        zero = jnp.zeros_like(inv_z)
        # d uv / d xc  [N, 2, 3]
        J_proj = jnp.stack([
            jnp.stack([fx * inv_z, zero, -fx * x_z * inv_z], -1),
            jnp.stack([zero, fy * inv_z, -fy * y_z * inv_z], -1),
        ], -2)
        # d xc / d tangent = [I | -hat(xc)]  [N, 3, 6]
        eye = jnp.broadcast_to(jnp.eye(3), xc.shape[:-1] + (3, 3))
        J_pose = jnp.concatenate([eye, -hat(xc)], axis=-1)
        J_uv = J_proj @ J_pose                    # [N, 2, 6]

        # dI/du from *reference* gradients (inverse-compositional approx)
        # J_i[p, q] = gx * J_uv[0] + gy * J_uv[1]  -> [N, P, P, 6]
        J = gx[..., None] * J_uv[:, None, None, 0, :] + \
            gy[..., None] * J_uv[:, None, None, 1, :]

        wi_full = wi[:, None, None]
        H = jnp.einsum("npqi,npqj->ij", J * wi_full[..., None], J)
        b = -jnp.einsum("npqi,npq->i", J * wi_full[..., None], r)
        cost = 0.5 * jnp.sum(wi_full * r * r)
        return H, b, cost

    def body(_, state):
        """LM with system reuse: (H, b, cost) are the normal equations AT
        the current best pose, so each iteration pays ONE residual_system
        evaluation — the trial evaluation doubles as the next iteration's
        linearization when the step is accepted (half the gathers of a
        two-evaluation formulation)."""
        T_best, lam, H, b, best = state
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6)
        delta = chol_solve_small(Hd, b)
        T_new = (SE3.exp(delta) @ T_best).normalize()
        H_new, b_new, new_cost = residual_system(T_new)
        ok = (new_cost < best) & jnp.isfinite(new_cost)
        T_next = jax.tree.map(lambda a, b_: jnp.where(ok, b_, a),
                              T_best, T_new)
        H2 = jnp.where(ok, H_new, H)
        b2 = jnp.where(ok, b_new, b)
        lam2 = jnp.where(ok, jnp.maximum(lam / 2.0, 1e-8),
                         jnp.minimum(lam * 4.0, 1e4))
        return T_next, lam2, H2, b2, jnp.where(ok, new_cost, best)

    H0, b0, cost0 = residual_system(T_init)
    T_fin, _, _, _, cost_fin = jax.lax.fori_loop(
        0, iters, body,
        (T_init, jnp.asarray(1e-3, jnp.float32), H0, b0, cost0))
    return AlignResult(T=T_fin, cost0=cost0, cost=cost_fin,
                       n_used=jnp.sum(use.astype(jnp.int32)))
