"""Camera models.

Batched re-design of the reference's AbstractCamera/Pinhole (reference
include/camera.hpp:17-91, src/camera.cpp:8-73): a frozen pytree with fully
*batched* projection ops instead of per-point virtuals.

* ``world2cam``: pinhole projection with radial (k1,k2,k3) + tangential
  (p1,p2) distortion — analytic, matching src/camera.cpp:51-73.
* ``cam2world``: iterative undistortion (fixed-point, like OpenCV
  ``undistortPoints`` used at src/camera.cpp:31-38) as a fixed-length
  ``fori_loop`` so it jits with static shapes; returns unit bearing vectors.
* ``is_in_frame``: per-pyramid-level bounds check (camera.hpp:45-51).

All ops broadcast over leading batch axes: px [..., 2], xyz [..., 3].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Pinhole:
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    # distortion (k1, k2, p1, p2, k3), reference src/camera.cpp:57-70
    dist: jnp.ndarray
    width: int = 0
    height: int = 0

    def tree_flatten(self):
        return (self.fx, self.fy, self.cx, self.cy, self.dist), (self.width, self.height)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, width, height, fx, fy, cx, cy, d=(0.0, 0.0, 0.0, 0.0, 0.0)) -> "Pinhole":
        f32 = jnp.float32
        return cls(
            fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
            dist=jnp.asarray(d, jnp.float32), width=int(width), height=int(height),
        )

    @classmethod
    def kitti(cls) -> "Pinhole":
        """KITTI grayscale cam used by every reference SLAM run
        (tests/test_pipeline.cpp:62-64, tests/slam/test_slam.cc:56-67)."""
        return cls.create(1240, 376, 718.856, 718.856, 607.1928, 185.2157)

    @property
    def K(self) -> jnp.ndarray:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack([
            jnp.stack([self.fx, z, self.cx], -1),
            jnp.stack([z, self.fy, self.cy], -1),
            jnp.stack([z, z, o], -1),
        ], -2)

    @property
    def has_distortion(self) -> jnp.ndarray:
        return jnp.any(jnp.abs(self.dist) > 1e-12)

    # ------------------------------------------------------------------
    def distort(self, xy: jnp.ndarray) -> jnp.ndarray:
        """Apply distortion to normalized coords [..., 2] (camera.cpp:57-70)."""
        k1, k2, p1, p2, k3 = (self.dist[i] for i in range(5))
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy2 = 2.0 * x * y
        xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * y * y)
        return jnp.stack([xd, yd], axis=-1)

    def undistort(self, xy: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
        """Invert ``distort`` by OpenCV-style fixed-point iteration."""
        def body(_, cur):
            k1, k2, p1, p2, k3 = (self.dist[i] for i in range(5))
            x, y = cur[..., 0], cur[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            xy2 = 2.0 * x * y
            dx = p1 * xy2 + p2 * (r2 + 2.0 * x * x)
            dy = p2 * xy2 + p1 * (r2 + 2.0 * y * y)
            nx = (xy[..., 0] - dx) / radial
            ny = (xy[..., 1] - dy) / radial
            return jnp.stack([nx, ny], axis=-1)

        return jax.lax.fori_loop(0, iters, body, xy)

    # ------------------------------------------------------------------
    def world2cam(self, xyz: jnp.ndarray) -> jnp.ndarray:
        """Camera-frame 3D points [..., 3] -> pixels [..., 2]."""
        z = jnp.where(jnp.abs(xyz[..., 2:3]) < 1e-12, 1e-12, xyz[..., 2:3])
        uv = self.project_normalized(xyz[..., :2] / z)
        return uv

    def project_normalized(self, xy: jnp.ndarray) -> jnp.ndarray:
        """Normalized image coords [..., 2] -> pixels (applies distortion)."""
        xyd = self.distort(xy)
        u = self.fx * xyd[..., 0] + self.cx
        v = self.fy * xyd[..., 1] + self.cy
        return jnp.stack([u, v], axis=-1)

    def cam2world(self, px: jnp.ndarray) -> jnp.ndarray:
        """Pixels [..., 2] -> unit bearing vectors [..., 3] (camera.cpp:25-41)."""
        x = (px[..., 0] - self.cx) / self.fx
        y = (px[..., 1] - self.cy) / self.fy
        xy = jnp.stack([x, y], axis=-1)
        xy = self.undistort(xy)
        f = jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)
        return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    # ------------------------------------------------------------------
    def is_in_frame(self, px: jnp.ndarray, boundary: float = 0.0, level: int = 0) -> jnp.ndarray:
        """Bounds check with per-level shrink (reference camera.hpp:45-51)."""
        scale = 2.0 ** level
        w = self.width / scale
        h = self.height / scale
        u, v = px[..., 0], px[..., 1]
        return (u >= boundary) & (v >= boundary) & (u < w - boundary) & (v < h - boundary)

    def error2(self, sigma: float = 1.0) -> jnp.ndarray:
        """Squared px error of one sigma at the focal plane (camera.hpp:55)."""
        return jnp.asarray(sigma) ** 2
