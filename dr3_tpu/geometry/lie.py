"""SO3 / SE3 Lie groups as JAX pytrees.

Replaces the reference's Sophus::SE3 dependency (reference include/frame.hpp:35,
include/global.hpp:24-35) with an in-repo, fully batched implementation:

* rotations are unit quaternions (wxyz) — cheap to normalize, compose, and
  store in struct-of-arrays pose tables [K, 7];
* ``exp``/``log`` use Taylor-guarded closed forms so they are safe under
  ``jit``/``vmap``/``grad`` at theta -> 0;
* every op broadcasts over leading batch dimensions, so pose tables are
  first-class: ``SE3(wxyz=[K,4], t=[K,3])``.

Conventions match the reference's SVO-style poses: ``T_f_w`` maps world ->
frame, ``pos() = -R^T t`` is the camera center in world (frame.hpp:82).
Tangent vectors are ``[rho(3), omega(3)]`` (translation first, like Sophus).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _register(cls):
    def unflatten(aux, children):
        # bypass __init__: JAX rebuilds pytrees from non-array leaves too
        # (abstract values when lowering a program), which jnp.asarray
        # would reject
        obj = object.__new__(cls)
        for name, v in zip(cls._fields, children):
            setattr(obj, name, v)
        return obj

    jax.tree_util.register_pytree_node(
        cls, lambda v: (v.tree_flatten_arrays(), None), unflatten)
    return cls


# ---------------------------------------------------------------------------
# quaternion primitives (wxyz)
# ---------------------------------------------------------------------------

def quat_multiply(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qvec = q[..., 1:]
    uv = jnp.cross(qvec, v)
    uuv = jnp.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] -> quaternion (wxyz), branch-free.

    Uses the four-candidate construction (one per largest diagonal term) and
    selects the numerically best with ``where`` — safe under vmap/jit.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                    1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    s = 2.0 * safe_sqrt(qw)  # [..., 4] candidate scales

    cand0 = jnp.stack([s[..., 0] / 4, (m21 - m12) / s[..., 0],
                       (m02 - m20) / s[..., 0], (m10 - m01) / s[..., 0]], axis=-1)
    cand1 = jnp.stack([(m21 - m12) / s[..., 1], s[..., 1] / 4,
                       (m01 + m10) / s[..., 1], (m02 + m20) / s[..., 1]], axis=-1)
    cand2 = jnp.stack([(m02 - m20) / s[..., 2], (m01 + m10) / s[..., 2],
                       s[..., 2] / 4, (m12 + m21) / s[..., 2]], axis=-1)
    cand3 = jnp.stack([(m10 - m01) / s[..., 3], (m02 + m20) / s[..., 3],
                       (m12 + m21) / s[..., 3], s[..., 3] / 4], axis=-1)

    idx = jnp.argmax(qw, axis=-1)
    cands = jnp.stack([cand0, cand1, cand2, cand3], axis=-2)  # [..., 4, 4]
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    # canonicalize sign (w >= 0) and normalize
    q = jnp.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """so3 hat: [..., 3] -> skew-symmetric [..., 3, 3]."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

@_register
class SO3:
    """Unit-quaternion rotation group, batched over leading axes."""

    _fields = ("wxyz",)

    def __init__(self, wxyz: jnp.ndarray):
        self.wxyz = jnp.asarray(wxyz)

    def tree_flatten_arrays(self):
        return (self.wxyz,)

    # constructors ----------------------------------------------------------
    @classmethod
    def identity(cls, batch: tuple = (), dtype: Any = jnp.float32) -> "SO3":
        q = jnp.zeros(batch + (4,), dtype).at[..., 0].set(1.0)
        return cls(q)

    @classmethod
    def from_matrix(cls, m: jnp.ndarray) -> "SO3":
        return cls(matrix_to_quat(jnp.asarray(m)))

    @classmethod
    def exp(cls, omega: jnp.ndarray) -> "SO3":
        """Rotation-vector exponential with theta->0 Taylor guard.

        Uses the safe-where pattern (guarded inputs inside the untaken
        branch) so gradients stay finite under autodiff at theta -> 0.
        """
        omega = jnp.asarray(omega)
        theta_sq = jnp.sum(omega**2, axis=-1, keepdims=True)
        use_taylor = theta_sq < _EPS
        safe_sq = jnp.where(use_taylor, 1.0, theta_sq)  # branch-safe input
        theta = jnp.sqrt(safe_sq)
        half = 0.5 * theta
        # sin(t/2)/t: Taylor 0.5 - t^2/48
        k = jnp.where(use_taylor, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta)
        w = jnp.where(use_taylor, 1.0 - theta_sq / 8.0, jnp.cos(half))
        return cls(jnp.concatenate([w, k * omega], axis=-1))

    # ops -------------------------------------------------------------------
    def log(self) -> jnp.ndarray:
        q = quat_normalize(self.wxyz)
        q = jnp.where(q[..., :1] < 0, -q, q)  # w >= 0 => theta in [0, pi]
        w = q[..., :1]
        vec = q[..., 1:]
        norm_sq = jnp.sum(vec**2, axis=-1, keepdims=True)
        use_taylor = norm_sq < _EPS
        safe_sq = jnp.where(use_taylor, 1.0, norm_sq)  # branch-safe input
        norm = jnp.sqrt(safe_sq)
        w_safe = jnp.maximum(w, _EPS)
        # atan2(|v|, w) * 2 / |v|; Taylor: 2/w - 2|v|^2/(3 w^3)
        k = jnp.where(
            use_taylor,
            2.0 / w_safe - 2.0 * norm_sq / (3.0 * w_safe**3),
            2.0 * jnp.arctan2(norm, w) / norm,
        )
        return k * vec

    def matrix(self) -> jnp.ndarray:
        return quat_to_matrix(quat_normalize(self.wxyz))

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        return quat_rotate(quat_normalize(self.wxyz), v)

    def inverse(self) -> "SO3":
        return SO3(quat_conjugate(self.wxyz))

    def __matmul__(self, other: "SO3") -> "SO3":
        return SO3(quat_multiply(self.wxyz, other.wxyz))

    def normalize(self) -> "SO3":
        return SO3(quat_normalize(self.wxyz))

    @property
    def batch_shape(self):
        return self.wxyz.shape[:-1]

    def __getitem__(self, idx) -> "SO3":
        return SO3(self.wxyz[idx])

    def __repr__(self):
        return f"SO3(wxyz={self.wxyz})"


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

@_register
class SE3:
    """Rigid transform T = (R, t): x -> R x + t, batched over leading axes."""

    _fields = ("wxyz", "t")

    def __init__(self, wxyz: jnp.ndarray, t: jnp.ndarray):
        self.wxyz = jnp.asarray(wxyz)
        self.t = jnp.asarray(t)

    def tree_flatten_arrays(self):
        return (self.wxyz, self.t)

    # constructors ----------------------------------------------------------
    @classmethod
    def identity(cls, batch: tuple = (), dtype: Any = jnp.float32) -> "SE3":
        q = jnp.zeros(batch + (4,), dtype).at[..., 0].set(1.0)
        return cls(q, jnp.zeros(batch + (3,), dtype))

    @classmethod
    def from_rotation_translation(cls, R: jnp.ndarray, t: jnp.ndarray) -> "SE3":
        return cls(matrix_to_quat(jnp.asarray(R)), jnp.asarray(t))

    @classmethod
    def from_matrix(cls, m: jnp.ndarray) -> "SE3":
        return cls(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])

    @classmethod
    def exp(cls, tangent: jnp.ndarray) -> "SE3":
        """tangent [..., 6] = [rho, omega] -> SE3, with left-Jacobian V."""
        tangent = jnp.asarray(tangent)
        rho, omega = tangent[..., :3], tangent[..., 3:]
        rot = SO3.exp(omega)
        theta_sq = jnp.sum(omega**2, axis=-1)[..., None, None]
        use_taylor = theta_sq < _EPS
        safe_sq = jnp.where(use_taylor, 1.0, theta_sq)  # branch-safe input
        theta = jnp.sqrt(safe_sq)
        W = hat(omega)
        WW = W @ W
        eye = jnp.broadcast_to(jnp.eye(3, dtype=tangent.dtype), WW.shape)
        A = jnp.where(use_taylor, 0.5 - theta_sq / 24.0,
                      (1.0 - jnp.cos(theta)) / safe_sq)
        B = jnp.where(use_taylor, 1.0 / 6.0 - theta_sq / 120.0,
                      (theta - jnp.sin(theta)) / (safe_sq * theta))
        V = eye + A * W + B * WW
        t = jnp.einsum("...ij,...j->...i", V, rho)
        return cls(rot.wxyz, t)

    # ops -------------------------------------------------------------------
    def log(self) -> jnp.ndarray:
        rot = SO3(self.wxyz)
        omega = rot.log()
        theta_sq = jnp.sum(omega**2, axis=-1)[..., None, None]
        use_taylor = theta_sq < _EPS
        safe_sq = jnp.where(use_taylor, 1.0, theta_sq)  # branch-safe input
        theta = jnp.sqrt(safe_sq)
        W = hat(omega)
        WW = W @ W
        eye = jnp.broadcast_to(jnp.eye(3, dtype=self.t.dtype), WW.shape)
        half_theta = 0.5 * theta
        # V^{-1} = I - W/2 + k W^2,  k = (1 - theta cos(t/2) / (2 sin(t/2))) / theta^2
        k = jnp.where(
            use_taylor,
            1.0 / 12.0 + theta_sq / 720.0,
            (1.0 - half_theta * jnp.cos(half_theta)
             / jnp.maximum(jnp.sin(half_theta), _EPS)) / safe_sq,
        )
        Vinv = eye - 0.5 * W + k * WW
        rho = jnp.einsum("...ij,...j->...i", Vinv, self.t)
        return jnp.concatenate([rho, omega], axis=-1)

    def rotation(self) -> SO3:
        return SO3(self.wxyz)

    def matrix(self) -> jnp.ndarray:
        """[..., 4, 4] homogeneous matrix."""
        R = quat_to_matrix(quat_normalize(self.wxyz))
        batch = R.shape[:-2]
        m = jnp.zeros(batch + (4, 4), dtype=R.dtype)
        m = m.at[..., :3, :3].set(R)
        m = m.at[..., :3, 3].set(self.t)
        m = m.at[..., 3, 3].set(1.0)
        return m

    def matrix34(self) -> jnp.ndarray:
        R = quat_to_matrix(quat_normalize(self.wxyz))
        return jnp.concatenate([R, self.t[..., :, None]], axis=-1)

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        return quat_rotate(quat_normalize(self.wxyz), v) + self.t

    def inverse(self) -> "SE3":
        qinv = quat_conjugate(quat_normalize(self.wxyz))
        return SE3(qinv, -quat_rotate(qinv, self.t))

    def __matmul__(self, other: "SE3") -> "SE3":
        return SE3(
            quat_multiply(self.wxyz, other.wxyz),
            quat_rotate(quat_normalize(self.wxyz), other.t) + self.t,
        )

    def center(self) -> jnp.ndarray:
        """Camera center in world for a world->frame pose (frame.hpp:82)."""
        return self.inverse().t

    def normalize(self) -> "SE3":
        return SE3(quat_normalize(self.wxyz), self.t)

    def retract(self, delta: jnp.ndarray) -> "SE3":
        """Left-multiplicative retraction: exp(delta) @ self (BA update)."""
        return SE3.exp(delta) @ self

    @property
    def batch_shape(self):
        return self.wxyz.shape[:-1]

    def params(self) -> jnp.ndarray:
        """Flat [..., 7] (wxyz, t) — SoA pose-table storage."""
        return jnp.concatenate([self.wxyz, self.t], axis=-1)

    @classmethod
    def from_params(cls, p: jnp.ndarray) -> "SE3":
        return cls(p[..., :4], p[..., 4:7])

    def __getitem__(self, idx) -> "SE3":
        return SE3(self.wxyz[idx], self.t[idx])

    def __repr__(self):
        return f"SE3(wxyz={self.wxyz}, t={self.t})"
