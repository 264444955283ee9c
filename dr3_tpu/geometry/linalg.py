"""Small-matrix linear algebra helpers tuned for batching.

The reference leans on OpenCV SVD for every DLT solve (reference
src/two.cpp:88,114,143,252, src/utils.cpp:82, src/initialization.cpp:160-168).
Here we want *batched* solves with static shapes; for the "smallest right
singular vector of A" pattern (null space of a DLT system) we use the
symmetric eigendecomposition of the small Gram matrix A^T A — A is 2Nx9 /
2Nx9 / 4x4, so the Gram matrix is at most 9x9 and `eigh` batches cleanly
under vmap (a single fused XLA kernel instead of N sequential SVDs).
"""

from __future__ import annotations

import jax.numpy as jnp


def smallest_eigvec_gram(A: jnp.ndarray, iters: int = 10) -> jnp.ndarray:
    """Right-singular vector of A [..., m, n] for its smallest singular value.

    Computed by fixed-count **inverse power iteration** on the Gram matrix
    A^T A (damped to PD, Cholesky factored once, ``iters`` unrolled
    triangular solves). Deliberately NOT ``jnp.linalg.eigh``: a batched
    eigh may lower to a data-dependent iterative loop — unbounded
    latency on pathological batches — while this is a static program of
    n^3/3-flop elementwise solves. DLT null spaces have a large eigen-gap,
    so ~10 iterations reach f32 accuracy; in a (near-)degenerate pencil any
    vector of the small-eigenvalue subspace is geometrically acceptable.
    """
    G = jnp.einsum("...ji,...jk->...ik", A, A)
    n = G.shape[-1]
    eye = jnp.eye(n, dtype=G.dtype)
    tr = jnp.trace(G, axis1=-2, axis2=-1)[..., None, None]
    Gd = G + (1e-7 * tr + 1e-20) * eye
    # fixed full-ones start: generic w.r.t. the null direction after the
    # first iteration (exact orthogonality does not survive one solve in f32)
    v = jnp.ones(G.shape[:-1], dtype=G.dtype)
    for _ in range(iters):
        v = chol_solve_small(Gd, v)
        v = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    return v


def solve_psd(A: jnp.ndarray, b: jnp.ndarray, damping: float = 0.0) -> jnp.ndarray:
    """Solve (A + damping I) x = b for symmetric PSD A via Cholesky."""
    n = A.shape[-1]
    if damping:
        A = A + damping * jnp.eye(n, dtype=A.dtype)
    L = jnp.linalg.cholesky(A)
    y = jnp.linalg.solve(L, b[..., None] if b.ndim == A.ndim - 1 else b)
    x = jnp.linalg.solve(jnp.swapaxes(L, -1, -2), y)
    return x[..., 0] if b.ndim == A.ndim - 1 else x


def chol_solve_small(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched Cholesky solve for tiny SPD systems, fully unrolled.

    A [..., n, n], b [..., n] with n static and small (<= ~8). XLA lowers
    ``jnp.linalg.solve``/``cholesky`` on tiny matrices to sequential LU /
    blocked loops whose launch latency dominates the actual math.
    Unrolling the factorization into n^3/3 elementwise ops keeps it one
    fused program, batched over the leading axes.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def chol3(m: jnp.ndarray) -> jnp.ndarray:
    """Batched lower-Cholesky factor of SPD [..., 3, 3] blocks, closed form
    (scalar VPU ops — no LU/Cholesky dispatch per block). Inputs are
    damped-PD by construction (BA Hpp^-1 blocks); sqrt args are floored so
    a degenerate block yields a finite (if inexact) factor instead of NaN.
    """
    eps = 1e-30
    a = jnp.sqrt(jnp.maximum(m[..., 0, 0], eps))
    b = m[..., 1, 0] / a
    c = m[..., 2, 0] / a
    d = jnp.sqrt(jnp.maximum(m[..., 1, 1] - b * b, eps))
    e = (m[..., 2, 1] - b * c) / d
    f = jnp.sqrt(jnp.maximum(m[..., 2, 2] - c * c - e * e, eps))
    z = jnp.zeros_like(a)
    return jnp.stack([
        a, z, z,
        b, d, z,
        c, e, f,
    ], axis=-1).reshape(m.shape)


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det) — no LU dispatch.

    Blocks normalize by their max |entry| first: BA Hpp blocks reach
    ~1e13 in real problems and the raw determinant (~|H|^3) overflows
    f32 to inf - inf = NaN (found round 5 on a real-structure BAL
    export). inv(M) = inv(M/s)/s."""
    scale = jnp.maximum(jnp.max(jnp.abs(m), axis=(-2, -1), keepdims=True),
                        1e-30)
    m = m / scale
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-20, jnp.sign(det) * 1e-20 + 1e-20, det)
    adj = jnp.stack([
        A, -(b * i - c * h), b * f - c * e,
        B, a * i - c * g, -(a * f - c * d),
        C, -(a * h - b * g), a * e - b * d,
    ], axis=-1).reshape(m.shape)
    return adj / (det[..., None, None] * scale)
