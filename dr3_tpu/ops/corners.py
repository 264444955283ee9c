"""Corner detection: dense FAST-10, Shi-Tomasi scoring, 3x3 NMS, grid bucketing.

Replacement for the reference's detection stack — the uzh-rpg
``fast`` SIMD library + per-corner Shi-Tomasi + occupancy grid
(reference src/features.cpp:43-98, src/utils.cpp:282-321). The reference is
sparse/sequential (detect corner list, then score each); on an accelerator the
idiomatic form is **dense**: compute a FAST score for *every* pixel as fused VPU
elementwise ops over 16 shifted copies of the image, NMS by comparing against
8 shifted score maps, then reduce to one best corner per grid cell with a
segment-max — static shapes end to end, one corner slot per cell exactly like
the reference's ``Corners(grid_n_cols * grid_n_rows)``.

Intensity convention: images are float32 in [0, 1]; FAST/Shi-Tomasi internally
scale gradients by 255 so thresholds keep reference parity (FAST arc
threshold 20, min Shi-Tomasi score 20 — src/features.cpp:59, config.cpp:12).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp

# FAST-10: 16 offsets (dx, dy) on the radius-3 Bresenham circle, in circular
# order starting at 12 o'clock.
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
FAST_ARC = 10  # contiguous arc length for FAST-10


def _shifted_stack(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W]: ring[k][y, x] = img[y + dy_k, x + dx_k] (borders wrap;
    callers mask the 3px border out)."""
    return jnp.stack(
        [jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1)) for dx, dy in FAST_OFFSETS]
    )


def fast_score_map(img: jnp.ndarray, threshold: float = 20.0) -> jnp.ndarray:
    """Dense FAST-10 corner score (reference fast_corner_detect_10 +
    fast_corner_score_10 at src/features.cpp:55-73, threshold 20).

    Score at p = max over contiguous 10-arcs that are entirely brighter
    (darker) than I(p)+t (I(p)-t) of the arc's min |I(k)-I(p)| — i.e. the
    classic "max threshold for which p stays a corner". Non-corners get 0.
    img is [H, W] in [0,1]; scores are in 0-255 intensity units.
    """
    x = img * 255.0
    ring = _shifted_stack(x)  # [16, H, W]
    d = ring - x[None]  # brighter: d > t ; darker: d < -t

    def arc_score(sign_d):
        """sign_d = d (bright) or -d (dark); both test sign_d > t."""
        ok = sign_d > threshold
        # all-ok and min over each contiguous arc of length 10
        all_ok = ok
        arc_min = sign_d
        for k in range(1, FAST_ARC):
            rolled_ok = jnp.roll(ok, -k, axis=0)
            rolled_d = jnp.roll(sign_d, -k, axis=0)
            all_ok = all_ok & rolled_ok
            arc_min = jnp.minimum(arc_min, rolled_d)
        # score per start s, masked by whole-arc pass; max over starts
        return jnp.max(jnp.where(all_ok, arc_min, 0.0), axis=0)

    score = jnp.maximum(arc_score(d), arc_score(-d))
    # 3px border cannot host a full circle
    h, w = img.shape[-2:]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(border, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep pixels that are the strict max of their 3x3 neighborhood
    (reference fast_nonmax_3x3, src/features.cpp:70-73)."""
    neigh = jnp.full_like(score, -jnp.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = jnp.maximum(neigh, jnp.roll(score, (-dy, -dx), axis=(-2, -1)))
    return (score > neigh) & (score > 0)


def gradients(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Central differences I(x+1)-I(x-1) (unnormalized, like utils.cpp:295-301),
    scaled to 0-255 intensity units."""
    x = img * 255.0
    dx = jnp.roll(x, -1, axis=-1) - jnp.roll(x, 1, axis=-1)
    dy = jnp.roll(x, -1, axis=-2) - jnp.roll(x, 1, axis=-2)
    return dx, dy


def _box_sum8(x: jnp.ndarray) -> jnp.ndarray:
    """Sum over the 8x8 box [y-4, y+4) x [x-4, x+4) at each pixel, matching
    the reference's loop bounds (utils.cpp:293-314). Separable shifts."""
    def axis_sum(v, axis):
        out = jnp.zeros_like(v)
        for o in range(-4, 4):
            out = out + jnp.roll(v, -o, axis=axis)
        return out

    return axis_sum(axis_sum(x, -1), -2)


def shi_tomasi_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense Shi-Tomasi min-eigenvalue score (utils.cpp:282-321 semantics:
    8x8 box of central-difference gradients, normalized by 2*box_area)."""
    dx, dy = gradients(img)
    box_area = 64.0
    dxx = _box_sum8(dx * dx) / (2.0 * box_area)
    dyy = _box_sum8(dy * dy) / (2.0 * box_area)
    dxy = _box_sum8(dx * dy) / (2.0 * box_area)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    disc = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
    score = 0.5 * (tr - disc)
    # reference returns 0 within 5px of the border (x_min<1 etc. with 4px box)
    h, w = img.shape[-2:]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inner = (ys >= 5) & (ys < h - 5) & (xs >= 5) & (xs < w - 5)
    return jnp.where(inner, score, 0.0)


def corner_response(img: jnp.ndarray, fast_threshold: float) -> jnp.ndarray:
    """Per-level response: Shi-Tomasi score at NMS-surviving FAST corners,
    zero elsewhere."""
    return jnp.where(nms3x3(fast_score_map(img, fast_threshold)),
                     shi_tomasi_map(img), 0.0)


class GridCorners(NamedTuple):
    """One corner slot per grid cell (SoA; fixed capacity = n_cells)."""

    xy: jnp.ndarray      # [n_cells, 2] level-0 pixel coords
    level: jnp.ndarray   # [n_cells] pyramid level of detection
    score: jnp.ndarray   # [n_cells] Shi-Tomasi score
    valid: jnp.ndarray   # [n_cells] bool

    @property
    def n(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


def detect_features(
    pyramid: List[jnp.ndarray],
    cell_size: int = 30,
    detection_threshold: float = 20.0,
    fast_threshold: float = 20.0,
    occupancy: Optional[jnp.ndarray] = None,
) -> GridCorners:
    """FastDetector::detect parity (src/features.cpp:43-98), dense formulation.

    Per level: FAST-10 score map -> 3x3 NMS -> Shi-Tomasi score at surviving
    pixels. Level maps are nearest-upsampled to level-0 resolution and
    combined by per-pixel max (tracking the winning level), then one
    pad + reshape + argmax per cell picks the best corner — pure dense
    reductions, no scatter/segment ops.
    ``occupancy`` [n_cells] True blocks a cell (the reference's
    grid_occupancy). Returns fixed-capacity GridCorners.
    """
    h0, w0 = pyramid[0].shape[-2:]
    n_cols = -(-w0 // cell_size)
    n_rows = -(-h0 // cell_size)
    n_cells = n_rows * n_cols

    # combined level-0-resolution score + winning-level maps
    score0 = jnp.zeros((h0, w0), jnp.float32)
    level0 = jnp.zeros((h0, w0), jnp.int32)
    for lvl, img in enumerate(pyramid):
        scale = 1 << lvl
        score = corner_response(img, fast_threshold)
        if lvl > 0:
            score = jnp.repeat(jnp.repeat(score, scale, axis=0), scale, axis=1)
            score = score[:h0, :w0]
            ph = h0 - score.shape[0]
            pw = w0 - score.shape[1]
            if ph or pw:
                score = jnp.pad(score, ((0, ph), (0, pw)))
        better = score > score0
        level0 = jnp.where(better, lvl, level0)
        score0 = jnp.maximum(score0, score)

    # pad to whole cells, reshape, argmax per cell
    H = n_rows * cell_size
    W = n_cols * cell_size
    score_p = jnp.pad(score0, ((0, H - h0), (0, W - w0)))
    level_p = jnp.pad(level0, ((0, H - h0), (0, W - w0)))
    cells = score_p.reshape(n_rows, cell_size, n_cols, cell_size)
    cells = cells.transpose(0, 2, 1, 3).reshape(n_cells, cell_size * cell_size)
    lcells = level_p.reshape(n_rows, cell_size, n_cols, cell_size)
    lcells = lcells.transpose(0, 2, 1, 3).reshape(n_cells, cell_size * cell_size)

    best_in_cell = jnp.argmax(cells, axis=1)
    best_score = jnp.take_along_axis(cells, best_in_cell[:, None], axis=1)[:, 0]
    best_level = jnp.take_along_axis(lcells, best_in_cell[:, None], axis=1)[:, 0]

    cell_row = jnp.arange(n_cells, dtype=jnp.int32) // n_cols
    cell_col = jnp.arange(n_cells, dtype=jnp.int32) % n_cols
    in_y = best_in_cell.astype(jnp.int32) // cell_size
    in_x = best_in_cell.astype(jnp.int32) % cell_size
    py = (cell_row * cell_size + in_y).astype(jnp.float32)
    px = (cell_col * cell_size + in_x).astype(jnp.float32)
    # snap coords to the winning level's grid (detection happened there)
    scale_f = (1 << best_level).astype(jnp.float32)
    px = jnp.floor(px / scale_f) * scale_f
    py = jnp.floor(py / scale_f) * scale_f

    found = best_score > detection_threshold
    if occupancy is not None:
        found = found & ~occupancy
    return GridCorners(xy=jnp.stack([px, py], -1),
                       level=best_level,
                       score=jnp.where(found, best_score, 0.0), valid=found)


def make_occupancy(xy: jnp.ndarray, valid: jnp.ndarray, img_hw: tuple[int, int],
                   cell_size: int) -> jnp.ndarray:
    """[n_cells] bool occupancy from existing feature pixels
    (Detector::flag_grid, src/features.cpp:23-27)."""
    h, w = img_hw
    n_cols = -(-w // cell_size)
    n_rows = -(-h // cell_size)
    n_cells = n_rows * n_cols
    cell = (xy[:, 1].astype(jnp.int32) // cell_size) * n_cols + \
        (xy[:, 0].astype(jnp.int32) // cell_size)
    cell = jnp.clip(cell, 0, n_cells - 1)
    occ = jnp.zeros((n_cells,), bool)
    return occ.at[cell].max(valid)
