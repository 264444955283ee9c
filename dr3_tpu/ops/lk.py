"""Pyramidal Lucas-Kanade feature tracking.

Replacement for ``cv::calcOpticalFlowPyrLK`` — the matching
engine of the reference's SVO init path (reference
src/initialization.cpp:593-613: 30px window, 4 levels, 30 iters, eps 1e-3,
USE_INITIAL_FLOW). Design:

* **batched over tracks**: all N tracks iterate together as one program —
  patch gathers are [N, W, W] bilinear samples, the 2x2 normal equations
  solve in closed form; no per-track host loop;
* **inverse-compositional GN**: spatial gradients and the 2x2 Hessian come
  from the *template* (previous frame) patch, computed once per level, so
  each iteration is one gather + two reductions;
* **fixed iteration count + convergence freeze**: iterations are a
  ``fori_loop`` with per-track ``converged`` masks instead of data-dependent
  exits (XLA static control flow).

Tracks carry (pos [N,2], ok [N], err [N]); failures are masked, never pruned
(the reference erases from vectors, initialization.cpp:621-627 — here
downstream ops consume the mask).
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp

from dr3_tpu.ops.warp import bilinear_sample


class TrackResult(NamedTuple):
    pos: jnp.ndarray  # [N, 2] tracked positions in the new image (level-0 px)
    ok: jnp.ndarray   # [N] bool: converged, in-bounds, well-conditioned
    err: jnp.ndarray  # [N] mean |residual| over the window (intensity 0-255)


def _patch_coords(center: jnp.ndarray, half: int) -> jnp.ndarray:
    """[N, W, W, 2] sample coordinates for WxW patches around centers [N,2]."""
    w = 2 * half + 1
    off = jnp.arange(-half, half + 1, dtype=center.dtype)
    oy, ox = jnp.meshgrid(off, off, indexing="ij")
    grid = jnp.stack([ox, oy], axis=-1)  # [W, W, 2]
    return center[:, None, None, :] + grid[None]


def track_level(
    img_prev: jnp.ndarray,
    img_next: jnp.ndarray,
    pts_prev: jnp.ndarray,
    guess: jnp.ndarray,
    half_window: int,
    iters: int,
    eps: float,
    min_eig: float = 1e-4,
):
    """One pyramid level of inverse-compositional LK.

    img_* [H, W] in [0,1]; pts_prev [N,2] template centers at this level's
    scale; guess [N,2] current position estimates. Returns (pos, ok, err).
    """
    coords = _patch_coords(pts_prev, half_window)  # [N, W, W, 2]
    T, t_ok = bilinear_sample(img_prev, coords, clamp=True)
    # template gradients by central differences of bilinear samples
    ex = jnp.zeros((2,), coords.dtype).at[0].set(1.0)
    ey = jnp.zeros((2,), coords.dtype).at[1].set(1.0)
    gx = (bilinear_sample(img_prev, coords + ex, clamp=True)[0]
          - bilinear_sample(img_prev, coords - ex, clamp=True)[0]) * 0.5
    gy = (bilinear_sample(img_prev, coords + ey, clamp=True)[0]
          - bilinear_sample(img_prev, coords - ey, clamp=True)[0]) * 0.5

    # 2x2 structure tensor per track (sum over window)
    gxx = jnp.sum(gx * gx, axis=(-2, -1))
    gxy = jnp.sum(gx * gy, axis=(-2, -1))
    gyy = jnp.sum(gy * gy, axis=(-2, -1))
    det = gxx * gyy - gxy * gxy
    n_px = (2 * half_window + 1) ** 2
    tr = gxx + gyy
    min_eig_val = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))) / n_px
    conditioned = min_eig_val > (min_eig / (255.0 ** 2))  # scores in [0,1] units
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)

    def body(_, state):
        pos, converged = state
        pcoords = _patch_coords(pos, half_window)
        I, _ = bilinear_sample(img_next, pcoords, clamp=True)
        r = I - T
        bx = jnp.sum(r * gx, axis=(-2, -1))
        by = jnp.sum(r * gy, axis=(-2, -1))
        # solve G d = b  (2x2 closed form); inverse-compositional: pos -= d
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        delta = jnp.stack([dx, dy], axis=-1)
        step = jnp.where(converged[:, None], 0.0, delta)
        new_pos = pos - step
        new_conv = converged | (jnp.sum(delta**2, axis=-1) < eps * eps)
        return new_pos, new_conv

    pos, _ = jax.lax.fori_loop(0, iters, body, (guess, jnp.zeros(guess.shape[0], bool)))

    final_coords = _patch_coords(pos, half_window)
    I, i_ok = bilinear_sample(img_next, final_coords, clamp=True)
    err = jnp.mean(jnp.abs(I - T), axis=(-2, -1)) * 255.0
    # center (not the whole window) must stay in both images: coarse pyramid
    # levels are too small to hold a full window near the border, and border
    # samples already read as masked zeros on both template and target.
    h, w = img_next.shape[-2:]
    center_in = (pos[:, 0] >= 0) & (pos[:, 1] >= 0) & \
        (pos[:, 0] <= w - 1) & (pos[:, 1] <= h - 1)
    return pos, conditioned & center_in, err


def track_pyramid(
    pyr_prev: List[jnp.ndarray],
    pyr_next: List[jnp.ndarray],
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    init: jnp.ndarray | None = None,
    half_window: int = 15,
    iters: int = 10,
    eps: float = 1e-2,
    max_err: float = 40.0,
) -> TrackResult:
    """Coarse-to-fine LK over an image pyramid (calcOpticalFlowPyrLK parity).

    pts [N,2] level-0 positions in prev; init optional level-0 initial
    guesses in next (USE_INITIAL_FLOW). Invalid tracks still compute (static
    shapes) but come back ok=False.
    """
    n_levels = len(pyr_prev)
    guess = (pts if init is None else init) / (2.0 ** (n_levels - 1))
    ok_all = jnp.ones(pts.shape[0], bool)
    err = jnp.zeros(pts.shape[0], pts.dtype)
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        pts_l = pts / scale
        pos, ok, err = track_level(pyr_prev[lvl], pyr_next[lvl], pts_l, guess,
                                   half_window, iters, eps)
        ok_all = ok_all & ok
        guess = pos * 2.0 if lvl > 0 else pos
    ok_final = ok_all & valid & (err < max_err)
    return TrackResult(pos=guess, ok=ok_final, err=err)


def extract_patches(img: jnp.ndarray, pts: jnp.ndarray, half: int) -> jnp.ndarray:
    """[N, W, W] clamp-sampled patches around pts (template storage for
    drift-free alignment)."""
    coords = _patch_coords(pts, half)
    vals, _ = bilinear_sample(img, coords, clamp=True)
    return vals


def align_to_templates(img: jnp.ndarray, templates: jnp.ndarray,
                       pos: jnp.ndarray, valid: jnp.ndarray,
                       iters: int = 8, eps: float = 1e-2,
                       max_err: float = 30.0, max_shift: float = 4.0) -> TrackResult:
    """Refine track positions against *stored* templates (SVO
    'feature_align', the stage the reference names in its timers but never
    built, src/handler.cpp:22-26): one inverse-compositional GN per track
    with gradients from the template patch. Because templates are captured
    at keyframes, per-frame tracking drift cannot accumulate between
    keyframes. ``max_shift`` bounds the correction (a larger jump means the
    frame-to-frame track already failed)."""
    n, W, _ = templates.shape
    half = (W - 1) // 2
    gy_t, gx_t = jnp.gradient(templates, axis=(-2, -1))
    gxx = jnp.sum(gx_t * gx_t, axis=(-2, -1))
    gxy = jnp.sum(gx_t * gy_t, axis=(-2, -1))
    gyy = jnp.sum(gy_t * gy_t, axis=(-2, -1))
    det = gxx * gyy - gxy * gxy
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)

    def body(_, state):
        p, converged = state
        coords = _patch_coords(p, half)
        I, _ = bilinear_sample(img, coords, clamp=True)
        r = I - templates
        bx = jnp.sum(r * gx_t, axis=(-2, -1))
        by = jnp.sum(r * gy_t, axis=(-2, -1))
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        delta = jnp.stack([dx, dy], axis=-1)
        step = jnp.where(converged[:, None], 0.0, delta)
        new_p = p - step
        new_conv = converged | (jnp.sum(delta**2, axis=-1) < eps * eps)
        return new_p, new_conv

    pos_r, _ = jax.lax.fori_loop(0, iters, body,
                                 (pos, jnp.zeros(n, bool)))
    coords = _patch_coords(pos_r, half)
    I, in_ok = bilinear_sample(img, coords, clamp=True)
    err = jnp.mean(jnp.abs(I - templates), axis=(-2, -1)) * 255.0
    shift = jnp.linalg.norm(pos_r - pos, axis=-1)
    h, w = img.shape[-2:]
    center_in = (pos_r[:, 0] >= 0) & (pos_r[:, 1] >= 0) & \
        (pos_r[:, 0] <= w - 1) & (pos_r[:, 1] <= h - 1)
    ok = valid & center_in & (err < max_err) & (shift <= max_shift)
    # reject the refinement (keep LK position) when it failed
    out_pos = jnp.where(ok[:, None], pos_r, pos)
    return TrackResult(pos=out_pos, ok=ok, err=err)
