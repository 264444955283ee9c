"""Dense image warps: bilinear remap, perspective/affine warp, spherical &
cylindrical projection.

Replacement for the reference's OpenCV warp calls —
``cv::remap`` (reference src/utils.cpp:189-194), ``cv::warpPerspective``
(src/stitch.cpp:73-74, src/panorama.cpp:192), ``cv::warpAffine`` and the
spherical/cylindrical warp-field generators (src/utils.cpp:125-272).

Everything is gather-based with static output shapes: a warp is "for every
output pixel, compute a source coordinate, bilinearly sample" — one fused
XLA program of elementwise math + 4 gathers, batchable over channels and
images. Out-of-bounds samples return 0 and a validity mask where relevant.
"""

from __future__ import annotations

import jax.numpy as jnp

from dr3_tpu.geometry.homography import apply_homography
from dr3_tpu.geometry.linalg import inv3x3


def bilinear_sample(img: jnp.ndarray, xy: jnp.ndarray, fill: float = 0.0,
                    clamp: bool = False):
    """Sample img [H, W] or [H, W, C] at xy [..., 2] (x=col, y=row).

    Returns (values [..., C?] , valid [...]) with bilinear interpolation;
    samples outside [0, W-1] x [0, H-1] get ``fill`` and valid=False —
    unless ``clamp`` (border-replicate, like cv BORDER_REPLICATE; valid
    still reports out-of-bounds).
    """
    has_c = img.ndim == 3
    H, W = img.shape[:2]
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    valid = (x >= 0) & (y >= 0) & (x <= W - 1) & (y <= H - 1)

    x0c = jnp.clip(x0i, 0, W - 1)
    x1c = jnp.clip(x0i + 1, 0, W - 1)
    y0c = jnp.clip(y0i, 0, H - 1)
    y1c = jnp.clip(y0i + 1, 0, H - 1)

    def gather(yy, xx):
        return img[yy, xx]  # advanced indexing -> XLA gather

    v00 = gather(y0c, x0c)
    v01 = gather(y0c, x1c)
    v10 = gather(y1c, x0c)
    v11 = gather(y1c, x1c)

    if has_c:
        wx_ = wx[..., None]
        wy_ = wy[..., None]
    else:
        wx_, wy_ = wx, wy
    top = v00 * (1 - wx_) + v01 * wx_
    bot = v10 * (1 - wx_) + v11 * wx_
    out = top * (1 - wy_) + bot * wy_
    if not clamp:
        vmask = valid[..., None] if has_c else valid
        out = jnp.where(vmask, out, fill)
    return out, valid


def remap(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, fill: float = 0.0) -> jnp.ndarray:
    """cv::remap parity (src/utils.cpp:189-194): out[i,j] = img(v[i,j], u[i,j])."""
    out, _ = bilinear_sample(img, jnp.stack([u, v], axis=-1), fill=fill)
    return out


def output_grid(h: int, w: int, dtype=jnp.float32) -> jnp.ndarray:
    """[h, w, 2] grid of (x, y) pixel coordinates."""
    ys = jnp.arange(h, dtype=dtype)
    xs = jnp.arange(w, dtype=dtype)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    return jnp.stack([gx, gy], axis=-1)


def warp_perspective(img: jnp.ndarray, H: jnp.ndarray, out_hw: tuple[int, int],
                     fill: float = 0.0):
    """cv::warpPerspective parity: map *src* through H into a canvas of
    out_hw. Output pixel p gets img(H^-1 p). Returns (warped, valid)."""
    oh, ow = out_hw
    grid = output_grid(oh, ow, img.dtype if img.dtype != jnp.uint8 else jnp.float32)
    src_xy = apply_homography(inv3x3(H), grid)
    return bilinear_sample(img, src_xy, fill=fill)


def warp_affine(img: jnp.ndarray, M: jnp.ndarray, out_hw: tuple[int, int],
                fill: float = 0.0):
    """cv::warpAffine parity with a 2x3 forward map M (inverted internally)."""
    H = jnp.concatenate([M, jnp.asarray([[0.0, 0.0, 1.0]], M.dtype)], axis=0)
    return warp_perspective(img, H, out_hw, fill=fill)


# ---------------------------------------------------------------------------
# spherical / cylindrical projection (src/utils.cpp:125-272 semantics)
# ---------------------------------------------------------------------------

def spherical_warp_field(h: int, w: int, f: float):
    """Inverse-warp field for spherical projection.

    Matches compute_spherical_warping (src/utils.cpp:125-187): output pixel
    (j, i) -> angles (x, y) = ((j - w/2)/f, (i - h/2)/f) -> unit sphere
    (sin x cos y, sin y, cos x cos y) -> perspective divide -> source pixel
    (w/2 + f*x/z, h/2 + f*y/z). Returns (u, v) each [h, w].
    """
    grid = output_grid(h, w)
    xf = (grid[..., 0] - 0.5 * w) / f
    yf = (grid[..., 1] - 0.5 * h) / f
    xhat = jnp.sin(xf) * jnp.cos(yf)
    yhat = jnp.sin(yf)
    zhat = jnp.cos(xf) * jnp.cos(yf)
    zhat = jnp.where(jnp.abs(zhat) < 1e-9, 1e-9, zhat)
    u = 0.5 * w + f * xhat / zhat
    v = 0.5 * h + f * yhat / zhat
    return u, v


def cylindrical_warp_field(h: int, w: int, f: float):
    """compute_cylindrical_warping parity (src/utils.cpp:204-271):
    cylinder point (sin th, height, cos th) with th=(j-w/2)/f,
    height=(i-h/2)/f."""
    grid = output_grid(h, w)
    theta = (grid[..., 0] - 0.5 * w) / f
    height = (grid[..., 1] - 0.5 * h) / f
    xhat = jnp.sin(theta)
    yhat = height
    zhat = jnp.cos(theta)
    zhat = jnp.where(jnp.abs(zhat) < 1e-9, 1e-9, zhat)
    u = 0.5 * w + f * xhat / zhat
    v = 0.5 * h + f * yhat / zhat
    return u, v


def warp_spherical(img: jnp.ndarray, f: float) -> jnp.ndarray:
    """warp_spherical parity (src/utils.cpp:196-201)."""
    u, v = spherical_warp_field(img.shape[0], img.shape[1], f)
    return remap(img, u, v)


def warp_cylindrical(img: jnp.ndarray, f: float) -> jnp.ndarray:
    u, v = cylindrical_warp_field(img.shape[0], img.shape[1], f)
    return remap(img, u, v)
