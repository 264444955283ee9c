"""Float64 numpy references for the image ops (bilinear sampling, warps,
LK, corner scores) — written independently of the JAX code they check."""

import numpy as np

from dr3_tpu.ops.corners import FAST_ARC, FAST_OFFSETS


def bilinear(img, x, y, clamp=False, fill=0.0):
    """Sample img [H, W] or [H, W, C] at float coords; returns (vals,
    valid) like ops.warp.bilinear_sample, in float64."""
    img = np.asarray(img, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    H, W = img.shape[:2]
    x0 = np.floor(x)
    y0 = np.floor(y)
    wx, wy = x - x0, y - y0
    with np.errstate(invalid="ignore"):
        xa = np.clip(np.nan_to_num(x0, nan=0.0), 0, W - 1).astype(np.int64)
        xb = np.clip(np.nan_to_num(x0 + 1, nan=0.0), 0, W - 1).astype(np.int64)
        ya = np.clip(np.nan_to_num(y0, nan=0.0), 0, H - 1).astype(np.int64)
        yb = np.clip(np.nan_to_num(y0 + 1, nan=0.0), 0, H - 1).astype(np.int64)
    if img.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
    top = img[ya, xa] * (1 - wx) + img[ya, xb] * wx
    bot = img[yb, xa] * (1 - wx) + img[yb, xb] * wx
    out = top * (1 - wy) + bot * wy
    valid = (x >= 0) & (y >= 0) & (x <= W - 1) & (y <= H - 1)
    if not clamp:
        out = np.where(valid[..., None] if img.ndim == 3 else valid, out,
                       fill)
    return out, valid


def patches(img, centers, half):
    """[N, W, W] clamp-sampled patches around centers [N, 2]."""
    off = np.arange(-half, half + 1, dtype=np.float64)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    c = np.asarray(centers, np.float64)
    return bilinear(img, c[:, 0, None, None] + ox, c[:, 1, None, None] + oy,
                    clamp=True)[0]


def track_level(img_prev, img_next, pts, guess, half, iters, eps,
                min_eig=1e-4):
    """Inverse-compositional LK on one level (calcOpticalFlowPyrLK step),
    float64: template gradients by central differences of bilinear
    samples, 2x2 normal equations per track, convergence freeze."""
    T = patches(img_prev, pts, half)
    e = np.asarray([1.0, 0.0])
    gx = 0.5 * (patches(img_prev, pts + e, half)
                - patches(img_prev, pts - e, half))
    gy = 0.5 * (patches(img_prev, pts + e[::-1], half)
                - patches(img_prev, pts - e[::-1], half))
    gxx = (gx * gx).sum((1, 2))
    gxy = (gx * gy).sum((1, 2))
    gyy = (gy * gy).sum((1, 2))
    det = gxx * gyy - gxy ** 2
    tr = gxx + gyy
    lam_min = 0.5 * (tr - np.sqrt(np.maximum(tr * tr - 4 * det, 0))) \
        / (2 * half + 1) ** 2
    det_s = np.where(np.abs(det) < 1e-12, 1e-12, det)
    pos = np.asarray(guess, np.float64).copy()
    done = np.zeros(len(pos), bool)
    for _ in range(iters):
        r = patches(img_next, pos, half) - T
        bx = (r * gx).sum((1, 2))
        by = (r * gy).sum((1, 2))
        d = np.stack([(gyy * bx - gxy * by) / det_s,
                      (gxx * by - gxy * bx) / det_s], -1)
        pos = pos - np.where(done[:, None], 0.0, d)
        done |= (d ** 2).sum(-1) < eps * eps
    err = np.abs(patches(img_next, pos, half) - T).mean((1, 2)) * 255.0
    h, w = np.asarray(img_next).shape
    inside = (pos[:, 0] >= 0) & (pos[:, 1] >= 0) & (pos[:, 0] <= w - 1) \
        & (pos[:, 1] <= h - 1)
    return pos, (lam_min > min_eig / 255.0 ** 2) & inside, err


def track_pyramid(pyr_prev, pyr_next, pts, valid, half, iters, eps,
                  max_err=40.0):
    """Coarse-to-fine LK over float64 copies of the given pyramids."""
    n = len(pyr_prev)
    pts = np.asarray(pts, np.float64)
    guess = pts / 2.0 ** (n - 1)
    ok_all = np.ones(len(pts), bool)
    for lvl in range(n - 1, -1, -1):
        pos, ok, err = track_level(pyr_prev[lvl], pyr_next[lvl],
                                   pts / 2.0 ** lvl, guess, half, iters, eps)
        ok_all &= ok
        guess = pos * 2.0 if lvl else pos
    return guess, ok_all & np.asarray(valid) & (err < max_err), err


def fast_score(img, threshold):
    """Dense FAST-10 score: the largest arc-min over contiguous 10-arcs of
    the radius-3 circle that are all brighter (darker) than centre +- t."""
    x = np.asarray(img, np.float64) * 255.0
    ring = np.stack([np.roll(x, (-dy, -dx), (0, 1)) for dx, dy in FAST_OFFSETS])
    d = ring - x[None]
    score = np.zeros_like(x)
    for sd in (d, -d):
        for s in range(16):
            arc = sd[[(s + k) % 16 for k in range(FAST_ARC)]]
            score = np.maximum(score, np.where((arc > threshold).all(0),
                                               arc.min(0), 0.0))
    h, w = x.shape
    score[:3] = 0
    score[h - 3:] = 0
    score[:, :3] = 0
    score[:, w - 3:] = 0
    return score


def nms3x3(score):
    h, w = score.shape
    p = np.pad(score, 1, mode="wrap")
    neigh = np.max([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                    if dx or dy], axis=0)
    return (score > neigh) & (score > 0)


def shi_tomasi(img):
    """Min eigenvalue of the 8x8-box structure tensor of central
    differences (0-255 units), zero within 5 px of the border."""
    x = np.asarray(img, np.float64) * 255.0
    dx = np.roll(x, -1, 1) - np.roll(x, 1, 1)
    dy = np.roll(x, -1, 0) - np.roll(x, 1, 0)

    def box(v):
        s = sum(np.roll(v, -o, 1) for o in range(-4, 4))
        return sum(np.roll(s, -o, 0) for o in range(-4, 4)) / 128.0
    a, b, c = box(dx * dx), box(dx * dy), box(dy * dy)
    tr = a + c
    out = 0.5 * (tr - np.sqrt(np.maximum(tr * tr - 4 * (a * c - b * b), 0)))
    h, w = x.shape
    inner = np.zeros_like(out, bool)
    inner[5:h - 5, 5:w - 5] = True
    return np.where(inner, out, 0.0)
