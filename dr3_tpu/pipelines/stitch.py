"""Pairwise image alignment + stitching.

Batched re-design of the reference's Stitch pipeline (reference
include/stitch.hpp:18-116, src/stitch.cpp:5-220):

reference                         | here
----------------------------------|----------------------------------------
ORB detect + BFMatch, top 20%     | FAST grid corners + ZNCC matmul matching
                                  |   (+ optional LK refinement)
sequential RANSAC x500, 4-pt DLT  | vmapped hypothesis-parallel RANSAC
  / 1-pt translate                |   (same minimal set sizes + semantics)
least_squares_fit on inliers      | masked weighted refit (same)
H.inv / h33, corner bbox canvas,  | identical canvas math, gather-based
  double warpPerspective, 50/50   |   warps, one fused blend
  addWeighted                     |

The correspondence + RANSAC stage is one jitted program per image size;
canvas sizing is host-side (4-corner math) because output shapes must be
static for XLA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dr3_tpu.geometry.ransac import ransac_homography
from dr3_tpu.io.image import to_gray
from dr3_tpu.ops import corners, lk, match, pyramid
from dr3_tpu.ops.warp import warp_perspective, warp_spherical
from dr3_tpu.utils.config import Config


@dataclasses.dataclass
class PairAlignment:
    H: np.ndarray          # 3x3 mapping left px -> right px
    n_inliers: int
    n_matches: int
    p_left: np.ndarray     # [N, 2] matched left points
    p_right: np.ndarray    # [N, 2] matched right points
    inliers: np.ndarray    # [N] bool


def find_correspondences(left_gray: jnp.ndarray, right_gray: jnp.ndarray,
                         cfg: Config, refine_lk: bool = True):
    """FAST grid corners on left, ZNCC-matched to FAST corners on right,
    optionally LK-refined to subpixel. Returns (p1, p2, weights)."""
    n_levels = min(cfg.n_pyr_levels, 3)
    pyr_l = pyramid.build_pyramid(left_gray, max(n_levels, cfg.klt_levels))
    pyr_r = pyramid.build_pyramid(right_gray, max(n_levels, cfg.klt_levels))
    f_l = corners.detect_features(pyr_l[:n_levels], cfg.cell_size,
                                  cfg.min_corner_score, cfg.fast_threshold)
    f_r = corners.detect_features(pyr_r[:n_levels], cfg.cell_size,
                                  cfg.min_corner_score, cfg.fast_threshold)
    d_l = match.patch_descriptors(left_gray, f_l.xy, f_l.valid)
    d_r = match.patch_descriptors(right_gray, f_r.xy, f_r.valid)
    m = match.match_descriptors(d_l, d_r, f_l.valid, f_r.valid)
    p1 = f_l.xy
    p2 = f_r.xy[m.idx2]
    w = m.ok
    if refine_lk:
        res = lk.track_pyramid(pyr_l, pyr_r, p1, w, init=p2,
                               half_window=cfg.klt_window // 2,
                               iters=cfg.klt_iters, eps=cfg.klt_eps)
        # accept refinement only where LK stayed near the descriptor match
        near = jnp.linalg.norm(res.pos - p2, axis=-1) < 5.0
        p2 = jnp.where((res.ok & near)[:, None], res.pos, p2)
    return p1, p2, w.astype(left_gray.dtype)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _pair_program(lg, rg, key, cfg: Config, translate_only: bool):
    """The whole correspondence + RANSAC stage as ONE jitted program:
    per-op eager dispatch would pay one launch per op, and every panorama
    pair shares the same image shape. Module-level (keyed on
    the frozen Config + mode, both hashable) so compiles are shared across
    Stitch *instances* — Panorama constructs a new Stitch per run and must
    not pay a recompile.

    Returns ONE packed flat f32 vector [6N + 11]: (p1, p2, w, inliers,
    model, n_inliers, n_matches), so the whole alignment reads back in a
    single device-to-host copy — and Panorama stacks the packed vectors
    of ALL pairs into one fetch."""
    p1, p2, w = find_correspondences(lg, rg, cfg)
    # reference uses 500 iters for stitching (stitch.hpp:50-52)
    res = ransac_homography(key, p1, p2, w, n_samples=500,
                            threshold=cfg.ransac_threshold,
                            translate_only=translate_only)
    f32 = jnp.float32
    return jnp.concatenate([
        p1.reshape(-1).astype(f32), p2.reshape(-1).astype(f32),
        w.astype(f32), res.inliers.astype(f32),
        res.model.reshape(-1).astype(f32),
        jnp.stack([res.n_inliers.astype(f32),
                   jnp.sum(w > 0).astype(f32)])])


def _warp_corners_np(H: np.ndarray, w: int, h: int) -> np.ndarray:
    """[4, 2] image corners through a homography — host numpy (a 4-point
    device dispatch + fetch would cost a device round trip each)."""
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]],
                 np.float32).T
    t = np.asarray(H, np.float32) @ c
    return (t[:2] / t[2:3]).T


class Stitch:
    """Pairwise aligner (reference Stitch, src/stitch.cpp)."""

    def __init__(self, cfg: Optional[Config] = None, translate_only: bool = False,
                 focal_length: float = 0.0, seed: int = 0):
        """translate_only + focal_length>0 mirrors the reference's
        Translate mode for spherically pre-warped inputs (stitch.hpp:50)."""
        self.cfg = cfg or Config()
        self.translate_only = translate_only
        self.focal_length = focal_length
        self.key = jax.random.PRNGKey(seed)

    def align_pair_async(self, left: np.ndarray, right: np.ndarray):
        """Dispatch the pair program; returns the packed device vector
        WITHOUT fetching (uploads are fast, round-trips are not — callers
        aligning many pairs overlap every dispatch and fetch once)."""
        lg = jnp.asarray(to_gray(left))
        rg = jnp.asarray(to_gray(right))
        self.key, sub = jax.random.split(self.key)
        return _pair_program(lg, rg, sub, self.cfg, self.translate_only)

    @staticmethod
    def unpack_alignment(flat: np.ndarray) -> PairAlignment:
        """Host-side decode of one packed pair-program vector."""
        flat = np.asarray(flat)
        n = (flat.shape[0] - 11) // 6
        p1 = flat[:2 * n].reshape(n, 2)
        p2 = flat[2 * n:4 * n].reshape(n, 2)
        w = flat[4 * n:5 * n]
        inl = flat[5 * n:6 * n] > 0.5
        model = flat[6 * n:6 * n + 9].reshape(3, 3)
        return PairAlignment(
            H=model, n_inliers=int(round(float(flat[6 * n + 9]))),
            n_matches=int(round(float(flat[6 * n + 10]))),
            p_left=p1, p_right=p2, inliers=inl,
        )

    def align_pair(self, left: np.ndarray, right: np.ndarray) -> PairAlignment:
        """Estimate H mapping left pixels into right pixels
        (reference align_pair + least_squares_fit, src/stitch.cpp:101-218).
        The packed program output fetches as a single host read."""
        return self.unpack_alignment(
            np.asarray(self.align_pair_async(left, right)))

    def process(self, left: np.ndarray, right: np.ndarray):
        """Full pair stitch (reference Stitch::process, src/stitch.cpp:29-82):
        canvas = bbox(corners(left) U Hinv corners(right)); warp both; 50/50
        blend. Returns (stitched [H, W, C], H_right_to_left 3x3)."""
        if self.translate_only and self.focal_length > 0:
            # both warps dispatch before the single stacked fetch
            lw = warp_spherical(jnp.asarray(left), self.focal_length)
            rw = warp_spherical(jnp.asarray(right), self.focal_length)
            if lw.shape == rw.shape:
                both = np.asarray(jnp.stack([lw, rw]))
                left, right = both[0], both[1]
            else:
                left, right = np.asarray(lw), np.asarray(rw)
        align = self.align_pair(left, right)
        Hinv = np.linalg.inv(align.H)
        Hinv = Hinv / Hinv[2, 2]

        h, w = right.shape[:2]
        corners_r = np.array([[0, 0], [w, 0], [0, h], [w, h]], np.float32)
        tr = _warp_corners_np(Hinv, w, h)
        xs = np.concatenate([tr[:, 0], corners_r[:, 0]])
        ys = np.concatenate([tr[:, 1], corners_r[:, 1]])
        min_x, min_y = xs.min(), ys.min()
        new_w = int(np.ceil(xs.max()) - np.floor(min_x))
        new_h = int(np.ceil(ys.max()) - np.floor(min_y))
        T = np.eye(3, dtype=np.float32)
        T[0, 2], T[1, 2] = -min_x, -min_y

        right_w, _ = warp_perspective(jnp.asarray(right),
                                      jnp.asarray(T @ Hinv), (new_h, new_w))
        left_w, _ = warp_perspective(jnp.asarray(left), jnp.asarray(T), (new_h, new_w))
        out = 0.5 * left_w + 0.5 * right_w
        return np.array(out), Hinv
