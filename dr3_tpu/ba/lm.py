"""Generic dense Levenberg-Marquardt with autodiff Jacobians.

The reference ships Ceres "exercise" programs — Powell's function
(tests/ceres/powell.cc), exponential curve fitting
(tests/ceres/curve_fitting.cc) and its Huber-robustified variant
(tests/ceres/robust_curve_fitting.cc) — as the general nonlinear
least-squares capability sitting beside the bundle adjuster. This module
is the JAX equivalent: a single jitted LM solver for ANY residual
function, with Jacobians from ``jax.jacfwd`` (the analogue of Ceres
autodiff cost functors, include/optimizer.hpp:82-111).

Design: dense normal equations (problems here are small — the big sparse
BA case has its own Schur solver in ba/schur_lm.py), Jacobi scaling of
J^T J, multiplicative damping, accept/reject trust-region loop under a
fixed-iteration ``lax.fori_loop`` (static control flow; rejected steps
re-use the cached linearization, only lambda moves). Optional Huber
robustification applies the standard "triggs" sqrt-weight to residual and
Jacobian rows, matching ceres::HuberLoss semantics to first order.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LMResult(NamedTuple):
    x: jnp.ndarray             # solution parameters [P]
    initial_cost: jnp.ndarray  # 0.5 * ||r(x0)||^2 (robustified)
    final_cost: jnp.ndarray
    n_accepted: jnp.ndarray    # accepted LM steps
    lambda_final: jnp.ndarray


def _robust_weights(r: jnp.ndarray, delta: float | None) -> jnp.ndarray:
    """Per-residual sqrt IRLS weight for a Huber loss of scale ``delta``."""
    if delta is None:
        return jnp.ones_like(r)
    a = jnp.abs(r)
    return jnp.sqrt(jnp.where(a <= delta, 1.0, delta / jnp.maximum(a, 1e-12)))


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def least_squares(residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
                  x0: jnp.ndarray,
                  max_iters: int = 50,
                  huber_delta: float | None = None,
                  lambda0: float = 1e-3) -> LMResult:
    """Minimize 0.5*||rho(residual_fn(x))||^2 over x by LM.

    ``residual_fn``: params [P] -> residuals [N] (pure, traceable).
    Returns an :class:`LMResult`; fixed ``max_iters`` outer iterations
    (rejected steps count as iterations, like Ceres' default reporting).
    """
    x0 = jnp.asarray(x0, jnp.float32)

    def linearize(x):
        r = residual_fn(x)
        J = jax.jacfwd(residual_fn)(x)
        w = _robust_weights(r, huber_delta)
        rw = w * r
        Jw = w[:, None] * J
        cost = 0.5 * jnp.sum(rw * rw)
        return rw, Jw, cost

    r0, J0, c0 = linearize(x0)

    def body(_, state):
        x, r, J, cost, lam, n_acc = state
        JtJ = J.T @ J
        g = J.T @ r
        # Jacobi scaling keeps the damped system well-conditioned in f32
        d = jnp.sqrt(jnp.clip(jnp.diag(JtJ), 1e-12, None))
        A = JtJ / (d[None, :] * d[:, None])
        A = A + lam * jnp.eye(A.shape[0], dtype=A.dtype)
        dx = -jnp.linalg.solve(A, g / d) / d
        x_new = x + dx
        r_new, J_new, cost_new = linearize(x_new)
        accept = cost_new < cost
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9),
                        jnp.minimum(lam * 2.0, 1e6))
        pick = lambda a, b: jnp.where(accept, a, b)
        return (pick(x_new, x), pick(r_new, r),
                jnp.where(accept, J_new, J), pick(cost_new, cost),
                lam, n_acc + accept.astype(jnp.int32))

    x, _, _, cost, lam, n_acc = jax.lax.fori_loop(
        0, max_iters, body,
        (x0, r0, J0, c0, jnp.asarray(lambda0, jnp.float32),
         jnp.asarray(0, jnp.int32)))
    return LMResult(x=x, initial_cost=c0, final_cost=cost,
                    n_accepted=n_acc, lambda_final=lam)
