"""Levenberg-Marquardt bundle adjustment on the Schur complement.

JAX-native replacement for the reference's Ceres solve — LM with
DENSE_SCHUR + SCHUR_JACOBI on 8 CPU threads (reference
src/optimizer.cpp:155-170). The reference's two recorded failure modes —
"Cholesky Decomposition fails during BA" and "Optimization is ridiculously
slow" (README.md:44-45) — are addressed by construction:

* **Jacobi (diagonal) scaling** of the reduced camera system plus Marquardt
  damping keeps the Cholesky well-conditioned in f32;
* the entire solve is one fused XLA program: Hessian blocks assemble via
  ``segment_sum`` over the observation table, the point blocks Hpp are 3x3
  block-diagonal and invert in closed form, and the reduced camera system
  assembles **observation-keyed** (ba/schur_core.py — the [K, P, 6, 3]
  coupling W is never materialized, so memory is O(O + K^2) like Ceres'
  partitioned DENSE_SCHUR, not O(K*P)).

Structure (standard Schur trick, matching DENSE_SCHUR's math):
    [Hcc  W ] [dc]   [bc]
    [W^T Hpp] [dp] = [bp]
    S dc = bc - W Hpp^-1 bp,   dp = Hpp^-1 (bp - W^T dc)

Solver selection: camera counts up to ``_EXPLICIT_MAX_CAMS`` get the exact
dense-S Cholesky ("explicit"); larger problems (BAL scale) switch to
matrix-free PCG with the SCHUR_JACOBI preconditioner — the same
preconditioner the reference configures (src/optimizer.cpp:161).

``optimize_intrinsics=True`` jointly optimizes the shared 4-param
(fx, fy, cx, cy) block, matching the reference's global_BA where the
intrinsics block is a *variable* parameter (src/optimizer.cpp:144-153,
include/optimizer.hpp:114-118 — AutoDiffCostFunction<., 2, 4, 6, 3>).

The LM loop runs a fixed number of iterations under ``lax.fori_loop`` with
accept/reject by cost comparison (lambda x2 up on reject, /3 down on
accept) — static control flow, fully jittable.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dr3_tpu.ba.problem import BAProblem, apply_update, linearize
from dr3_tpu.ba.schur_core import assemble_blocks, solve_schur
from dr3_tpu.geometry.linalg import chol_solve_small

# beyond this camera count the dense [6K, 6K] Cholesky stops being the
# right tool and the matrix-free PCG path takes over
_EXPLICIT_MAX_CAMS = 64


class BAResult(NamedTuple):
    problem: BAProblem
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    n_accepted: jnp.ndarray
    lambda_final: jnp.ndarray


def _params_finite(p: BAProblem) -> jnp.ndarray:
    """Scalar bool: every optimized parameter is finite."""
    return (jnp.all(jnp.isfinite(p.cam_wxyz)) & jnp.all(jnp.isfinite(p.cam_t))
            & jnp.all(jnp.isfinite(p.points))
            & jnp.all(jnp.isfinite(p.intrinsics)))


def _solve_once(p: BAProblem, lam, huber_delta: float, jacobi: bool,
                optimize_intrinsics: bool, method: str, d_max: int,
                cg_iters: int, cg_tol: float = 1e-5, q_eta: float = 0.0,
                res=None, cam_onehot=None):
    if res is None:
        res = linearize(p, huber_delta, with_intrinsics=optimize_intrinsics)
    active = (p.obs_w > 0) & res.valid
    blocks = assemble_blocks(res.r, res.Jc, res.Jp, p.obs_cam, p.obs_pt,
                             active, p.n_cams, p.n_points, Jg=res.Jg,
                             cam_onehot=cam_onehot)
    dc, dp, dg = solve_schur(blocks, lam, p.cam_fixed, method=method,
                             d_max=d_max, jacobi=jacobi, cg_iters=cg_iters,
                             cg_tol=cg_tol, q_eta=q_eta)
    return res.cost, apply_update(p, dc, dp, dg)


def _pick_solver(problem: BAProblem, solver: str):
    if solver == "auto":
        # zexplicit = the same exact dense-S Cholesky, with the correction
        # built as Z^T Z (one scatter + one matmul); re-deciding this on
        # the GPU is open (tools/profile_window_ba.py times the methods)
        return "zexplicit" if problem.n_cams <= _EXPLICIT_MAX_CAMS else "pcg"
    return solver


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 5, 6, 7, 8, 9, 10))
def bundle_adjust(problem: BAProblem, max_iters: int = 20,
                  huber_delta: float = 5.0, jacobi: bool = True,
                  lambda0: float = 1e-3, optimize_intrinsics: bool = False,
                  solver: str = "auto", d_max: int | None = None,
                  cg_iters: int = 100, cg_tol: float = 1e-5,
                  q_eta: float = 0.0) -> BAResult:
    """Full LM loop (global_BA parity, src/optimizer.cpp:131-175).

    LM with linearization reuse: the accept-cost evaluation at the trial
    point IS the next iteration's linearization when the step is accepted,
    so each iteration pays exactly one linearize (the previous formulation
    paid two). ``cg_tol``/``q_eta``
    forward to the PCG solve (q_eta>0 = Ceres' inexact-Newton forcing)."""
    method = _pick_solver(problem, solver)
    if d_max is None:
        # window-style problems observe each point at most once per camera
        d_max = min(problem.n_cams, problem.n_obs)
    res0 = linearize(problem, huber_delta,
                     with_intrinsics=optimize_intrinsics)
    cost0 = res0.cost
    # camera one-hot built once, reused every iteration (see assemble_blocks)
    E = None
    if problem.n_obs * problem.n_cams <= 256 * 1024 * 1024:
        from dr3_tpu.ba.schur_core import cam_onehot_matrix

        E = cam_onehot_matrix(problem.obs_cam, problem.n_cams)

    def body(_, state):
        p, res, lam, best_cost, n_acc = state
        cost, p_new = _solve_once(p, lam, huber_delta, jacobi,
                                  optimize_intrinsics, method, d_max,
                                  cg_iters, cg_tol, q_eta, res=res,
                                  cam_onehot=E)
        res_new = linearize(p_new, huber_delta,
                            with_intrinsics=optimize_intrinsics)
        new_cost = res_new.cost
        # a nan/inf candidate masks its own observations inside linearize
        # (cost drops to ~0), so finite cost alone is not an accept
        # criterion — the parameters themselves must stay finite
        ok = (new_cost < best_cost) & jnp.isfinite(new_cost) \
            & _params_finite(p_new)
        p_next = jax.tree.map(lambda a, b: jnp.where(ok, b, a), p, p_new)
        res_next = jax.tree.map(lambda a, b: jnp.where(ok, b, a), res,
                                res_new)
        lam_next = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                             jnp.minimum(lam * 2.0, 1e6))
        best = jnp.where(ok, new_cost, best_cost)
        return p_next, res_next, lam_next, best, n_acc + ok.astype(jnp.int32)

    init = (problem, res0, jnp.asarray(lambda0, jnp.float32), cost0,
            jnp.asarray(0, jnp.int32))
    p_fin, _, lam_fin, cost_fin, n_acc = jax.lax.fori_loop(0, max_iters,
                                                           body, init)
    return BAResult(problem=p_fin, initial_cost=cost0, final_cost=cost_fin,
                    n_accepted=n_acc, lambda_final=lam_fin)


@functools.partial(jax.jit, static_argnums=(1, 2))
def pose_only_adjust(problem: BAProblem, max_iters: int = 10,
                     huber_delta: float = 5.0) -> BAResult:
    """Motion-only BA: optimize camera poses with points frozen (the VO
    'pose_optimizer' stage the reference registers a timer for but never
    implemented, src/handler.cpp:22-26). Plain damped GN on [K, 6] blocks —
    no Schur needed."""
    cost0 = linearize(problem, huber_delta).cost
    K = problem.n_cams
    eye6 = jnp.eye(6, dtype=problem.cam_t.dtype)

    def body(_, state):
        p, lam, best_cost, n_acc = state
        res = linearize(p, huber_delta)
        AtA = jnp.einsum("oij,oik->ojk", res.Jc, res.Jc)
        Atr = jnp.einsum("oij,oi->oj", res.Jc, res.r)
        H = jax.ops.segment_sum(AtA, p.obs_cam, num_segments=K)
        b = -jax.ops.segment_sum(Atr, p.obs_cam, num_segments=K)
        H = H + eye6 * (lam * jnp.diagonal(H, axis1=-2, axis2=-1) + 1e-8)[..., None, :]
        dc = chol_solve_small(H, b)
        p_new = apply_update(p, dc, jnp.zeros_like(p.points))
        new_cost = linearize(p_new, huber_delta).cost
        ok = (new_cost < best_cost) & jnp.isfinite(new_cost) \
            & _params_finite(p_new)
        p_next = jax.tree.map(lambda a, b_: jnp.where(ok, b_, a), p, p_new)
        lam_next = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-9),
                             jnp.minimum(lam * 2.0, 1e6))
        best = jnp.where(ok, new_cost, best_cost)
        return p_next, lam_next, best, n_acc + ok.astype(jnp.int32)

    init = (problem, jnp.asarray(1e-3, jnp.float32), cost0, jnp.asarray(0, jnp.int32))
    p_fin, lam_fin, cost_fin, n_acc = jax.lax.fori_loop(0, max_iters, body, init)
    return BAResult(problem=p_fin, initial_cost=cost0, final_cost=cost_fin,
                    n_accepted=n_acc, lambda_final=lam_fin)
