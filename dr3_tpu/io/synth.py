"""Synthetic 3D scene rendering with exact ground truth — the input source
for tests, benchmarks and the chip smoke run (the reference's verification
was visual only, SURVEY §4).

Renders a two-plane scene (near textured plane inside a far background
plane) or an endless textured corridor by ray-plane intersection +
bilinear texture lookup. Two depths break the planar degeneracy of
fundamental-matrix initialization. Everything is seeded numpy on the host:
frames are made in bulk before any device work, so rendering never
interleaves with device dispatches.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from scipy import ndimage

from dr3_tpu.geometry.lie import SE3


def make_textures(rng, size=1600):
    """High-contrast binary-blob textures (FAST-friendly)."""
    def tex(seed_shift):
        base = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 2.5)
        soft = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 1.0)
        return (0.6 * (base > np.median(base)) + 0.4 * soft).astype(np.float32)

    return tex(0), tex(1)


def _np_skew(omega):
    return np.array([[0.0, -omega[2], omega[1]],
                     [omega[2], 0.0, -omega[0]],
                     [-omega[1], omega[0], 0.0]], np.float64)


class NpSE3:
    """Pure-numpy world->cam rigid transform for fixture generation (pose
    math feeding the numpy renderer stays on the host). Mirrors
    dr3_tpu.geometry.lie.SE3.exp exactly: tangent [rho, omega],
    t = V(omega) @ rho with the left Jacobian V.
    """

    def __init__(self, R, t):
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)

    @classmethod
    def exp(cls, tangent):
        tangent = np.asarray(tangent, np.float64)
        rho, omega = tangent[:3], tangent[3:]
        theta = float(np.linalg.norm(omega))
        K = _np_skew(omega)
        if theta < 1e-8:
            R = np.eye(3) + K + 0.5 * (K @ K)
            V = np.eye(3) + 0.5 * K + (K @ K) / 6.0
        else:
            A = np.sin(theta) / theta
            B = (1.0 - np.cos(theta)) / theta**2
            C = (theta - np.sin(theta)) / theta**3
            R = np.eye(3) + A * K + B * (K @ K)
            V = np.eye(3) + B * K + C * (K @ K)
        return cls(R, V @ rho)

    def center(self):
        return (-self.R.T @ self.t).astype(np.float32)


def _pose_rt(T):
    """(R, t) of a world->cam pose as numpy float32, without device ops."""
    if isinstance(T, NpSE3):
        return T.R.astype(np.float32), T.t.astype(np.float32)
    w, x, y, z = (float(v) for v in np.asarray(T.wxyz, np.float64))
    n = (w * w + x * x + y * y + z * z) ** -0.5
    w, x, y, z = w * n, x * n, y * n, z * n
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return R, np.asarray(T.t, np.float32)


def render_scene(cam, T, tex_near, tex_far, z_near=6.0, z_far=14.0,
                 near_halfw=2.2, near_halfh=1.6, px_per_unit=60.0):
    """Render the scene from world->cam pose T (SE3 or NpSE3). The near
    plane (z=z_near) occupies |x|<near_halfw, |y|<near_halfh; the far plane
    fills the rest."""
    h, w = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    R_wc, t_wc = _pose_rt(T)
    R = R_wc.T                      # cam->world rotation
    t = -R_wc.T @ t_wc              # camera center in world
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d_w = d_cam @ R.T

    def plane_hit(z_plane):
        lam = (z_plane - t[2]) / np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9,
                                          d_w[..., 2])
        pw = t + lam[..., None] * d_w
        return pw, lam

    pw_n, lam_n = plane_hit(z_near)
    pw_f, lam_f = plane_hit(z_far)
    near_mask = (np.abs(pw_n[..., 0]) < near_halfw) & \
        (np.abs(pw_n[..., 1]) < near_halfh) & (lam_n > 0)

    def lookup(tex, pw):
        # pure-numpy bilinear lookup: rendering stays on the host, so a
        # long sequence never re-uploads the texture per frame
        txy = pw[..., :2] * px_per_unit + np.asarray(tex.shape)[::-1] / 2.0
        th, tw = tex.shape
        x = np.clip(txy[..., 0], 0.0, tw - 1.001)
        y = np.clip(txy[..., 1], 0.0, th - 1.001)
        x0 = x.astype(np.int32)
        y0 = y.astype(np.int32)
        ax = (x - x0).astype(np.float32)
        ay = (y - y0).astype(np.float32)
        v00 = tex[y0, x0]
        v01 = tex[y0, x0 + 1]
        v10 = tex[y0 + 1, x0]
        v11 = tex[y0 + 1, x0 + 1]
        return ((1 - ay) * ((1 - ax) * v00 + ax * v01)
                + ay * ((1 - ax) * v10 + ax * v11))

    img = np.where(near_mask, lookup(tex_near, pw_n), lookup(tex_far, pw_f))
    return img.astype(np.float32)


def _bilinear_periodic(tex, u, v):
    """Periodic (tiled) bilinear texture lookup — pure numpy (host-side
    rendering, like render_scene's lookup)."""
    th, tw = tex.shape
    x = np.mod(u, tw - 1.001).astype(np.float32)
    y = np.mod(v, th - 1.001).astype(np.float32)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    ax = x - x0
    ay = y - y0
    v00 = tex[y0, x0]
    v01 = tex[y0, x0 + 1]
    v10 = tex[y0 + 1, x0]
    v11 = tex[y0 + 1, x0 + 1]
    return ((1 - ay) * ((1 - ax) * v00 + ax * v01)
            + ay * ((1 - ax) * v10 + ax * v11))


def render_corridor(cam, T, tex_ground, tex_wall, ground_y=1.5, wall_x=4.0,
                    px_per_unit=50.0):
    """Render an ENDLESS corridor scene: textured ground plane (y=ground_y,
    +y is down) and two textured side walls (x=±wall_x), tiled periodically
    along the driving direction (+z); rays above the horizon hit a
    featureless sky. Unlike the two-plane lateral scene (render_scene),
    this supports unbounded FORWARD motion with turns — the KITTI-like
    regime where parallax vanishes near the focus of expansion (the
    reference's demonstrated use case, reference README.md:4-5)."""
    h, w = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    R_wc, t_wc = _pose_rt(T)
    R = R_wc.T
    t = -R_wc.T @ t_wc
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d_w = d_cam @ R.T

    INF = np.float32(1e9)

    def plane(axis, value):
        denom = d_w[..., axis]
        lam = (value - t[axis]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        return np.where(lam > 1e-3, lam, INF).astype(np.float32)

    lams = np.stack([plane(1, ground_y), plane(0, -wall_x),
                     plane(0, wall_x)])
    choice = np.argmin(lams, 0)
    lam = np.min(lams, 0)
    pw = t.astype(np.float32) + lam[..., None] * d_w.astype(np.float32)

    img_g = _bilinear_periodic(tex_ground, pw[..., 0] * px_per_unit,
                               pw[..., 2] * px_per_unit)
    # walls keyed by (z, y); the left wall samples a half-texture offset so
    # the two walls never alias in place recognition
    off = tex_wall.shape[1] / 2.0
    img_l = _bilinear_periodic(tex_wall, pw[..., 2] * px_per_unit + off,
                               pw[..., 1] * px_per_unit)
    img_r = _bilinear_periodic(tex_wall, pw[..., 2] * px_per_unit,
                               pw[..., 1] * px_per_unit)
    img = np.where(choice == 0, img_g, np.where(choice == 1, img_l, img_r))
    img = np.where(lam >= INF, np.float32(0.5), img)  # featureless sky
    return img.astype(np.float32)


def corridor_path(n_frames, step=0.10, curve_amp=0.22, period=240,
                  rot_only_at=0.45, rot_only_len=12, rot_rate=0.02):
    """Forward-dominant ground-truth path down the corridor: S-curve
    heading (yaw = curve_amp*sin(2*pi*i/period), turns up to ~±13 deg) plus
    one ROTATION-ONLY stress segment (position frozen, yaw sweeps
    +rot_rate/frame for rot_only_len frames then back — zero net heading,
    zero parallax while it lasts). Returns (NpSE3 world->cam poses [n],
    centers [n, 3])."""
    poses, centers = [], []
    pos = np.zeros(3, np.float64)
    s0 = int(rot_only_at * n_frames)
    s1 = s0 + rot_only_len
    s2 = s1 + rot_only_len
    extra = 0.0
    for i in range(n_frames):
        base_yaw = curve_amp * np.sin(2.0 * np.pi * i / period)
        if s0 <= i < s1:
            extra += rot_rate
            advance = 0.0
        elif s1 <= i < s2:
            extra -= rot_rate
            advance = 0.0
        else:
            advance = step
        yaw = base_yaw + extra
        d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + advance * d
        # cam->world = Ry(yaw); world->cam pose (R_wc, t_wc = -R_wc @ c)
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        R_wc = R_cw.T
        poses.append(NpSE3(R_wc, -R_wc @ pos))
        centers.append(pos.copy())
    return poses, np.asarray(centers, np.float32)


def forward_trajectory(n_frames, step=0.12, yaw_rate=0.004):
    """Ground-truth world->cam poses: forward motion with gentle yaw."""
    poses = []
    for i in range(n_frames):
        tau = np.asarray([0.01 * i, 0.002 * i, -step * i,
                          0.0, yaw_rate * i, 0.0], np.float32)
        poses.append(SE3.exp(jnp.asarray(tau)))
    return poses


def gt_centers(poses):
    return np.stack([np.asarray(p.center()) for p in poses])


# ---------------------------------------------------------------------------
# seeded inputs at the sizes the benchmark and the chip smoke run use
# ---------------------------------------------------------------------------

def out_and_back_poses(n_frames, lateral=2.4, forward=1.2, yaw=0.03):
    """World->cam NpSE3 poses that move out (sideways and forward) and come
    back to the start over ``n_frames``: a raised-cosine path, so the
    return leg revisits the outward views (loop-closure candidates)."""
    poses = []
    for i in range(n_frames):
        s = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_frames))
        tau = np.asarray([-lateral * s, 0.0, -forward * s,
                          0.0, yaw * np.sin(2.0 * np.pi * i / n_frames),
                          0.0])
        poses.append(NpSE3.exp(tau))
    return poses


def render_sequence(cam, poses, rng, texture_size=2048):
    """Frames [H, W] float32 in [0, 1] of the two-plane scene along
    ``poses``; ``cam`` needs width/height/fx/fy/cx/cy."""
    tex_near, tex_far = make_textures(rng, size=texture_size)
    return [render_scene(cam, T, tex_near, tex_far) for T in poses]


def panorama_views(rng, n_views=8, width=640, height=480, f=600.0,
                   yaw_step=0.09):
    """``n_views`` overlapping RGB views [H, W, 3] in [0, 1] from a camera
    that pans (pure yaw) across the two-plane scene — the input of a
    spherical-pre-warp panorama with focal length ``f``."""
    from types import SimpleNamespace

    cam = SimpleNamespace(width=width, height=height, fx=f, fy=f,
                          cx=width / 2.0, cy=height / 2.0)
    tex_near, tex_far = make_textures(rng, size=2400)
    views = []
    for k in range(n_views):
        yaw = yaw_step * (k - 0.5 * (n_views - 1))
        g = render_scene(cam, NpSE3.exp([0.0, 0.0, 0.0, 0.0, yaw, 0.0]),
                         tex_near, tex_far, z_near=9.0, z_far=14.0)
        views.append(np.stack([g, 0.7 * g + 0.15, 1.0 - 0.8 * g],
                              -1).astype(np.float32))
    return views


def window_ba_problem(rng, n_cams=32, n_pts=16384, n_tracks=546):
    """BA problem at the VO window's shapes: ``n_cams`` keyframes x
    ``n_pts`` points x ``n_cams * n_tracks`` observations (one slot per
    keyframe and track), KITTI intrinsics, 0.3 px noise."""
    from dr3_tpu.ba.problem import make_problem, project
    from dr3_tpu.geometry.lie import SE3

    intr = jnp.asarray([718.856, 718.856, 607.19, 185.22])
    pts = np.stack([rng.uniform(-20, 20, n_pts), rng.uniform(-5, 5, n_pts),
                    rng.uniform(5, 60, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 2] = -0.8 * np.arange(n_cams)
    cams = SE3.exp(jnp.asarray(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_tracks).astype(np.int32)
    obs_pt = np.concatenate([
        (rng.permutation(n_pts)[:n_tracks]).astype(np.int32)
        for _ in range(n_cams)])
    uv = np.array(project(intr, cams[obs_cam].apply(
        jnp.asarray(pts)[obs_pt])))
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    w = (np.abs(uv[:, 0] - 607) < 650) & (np.abs(uv[:, 1] - 185) < 230)
    return make_problem(cams, pts0, intr, obs_cam, obs_pt, uv,
                        obs_w=w.astype(np.float32))


def bal_problem(rng, n_cams=120, n_pts=60000, per_cam=4000):
    """Snavely BAL problem with ``n_cams`` cameras on a line, each seeing a
    sliding band of ``per_cam`` of the ``n_pts`` points (``n_cams *
    per_cam`` observations), 0.5 px noise."""
    from dr3_tpu.ba.snavely import bal_to_snavely
    from dr3_tpu.io.bal import BALData

    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(-30, -15, n_pts)], 1)
    cam = np.zeros((n_cams, 9))
    cam[:, 3] = np.linspace(-8, 8, n_cams)
    cam[:, 6] = 1000.0
    oc = np.repeat(np.arange(n_cams), per_cam).astype(np.int32)
    op = np.concatenate([
        np.arange(int(k * (n_pts - per_cam) / (n_cams - 1)),
                  int(k * (n_pts - per_cam) / (n_cams - 1)) + per_cam)
        for k in range(n_cams)]).astype(np.int32)
    pc = pts[op] + cam[oc, 3:6]
    uv = -1000.0 * pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5, (len(oc), 2))
    return bal_to_snavely(BALData(cam, pts + rng.normal(0, 0.05, pts.shape),
                                  oc, op, uv))
