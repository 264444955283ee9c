"""Hypothesis-parallel RANSAC.

The reference runs sequential RANSAC loops in three places — F-matrix, 30
iters (src/two.cpp:46-111); homography stitching, 500 iters
(src/stitch.cpp:109-153); and the initializer's 200 pre-sampled 8-point sets
(src/initialization.cpp:48-64). On an accelerator the idiomatic form is the one the
initializer already hints at: **pre-sample all minimal sets up front, fit and
score every hypothesis in parallel with vmap, argmax the score** — no
data-dependent loop, one fused XLA program.

Generic driver: ``ransac(key, fit, score, data, n_samples, sample_size)``;
concrete front-ends for homography (stitch parity) and fundamental matrix
(initializer parity) live beside it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from dr3_tpu.geometry import epipolar, homography


class RansacResult(NamedTuple):
    model: jnp.ndarray     # best model parameters
    inliers: jnp.ndarray   # [N] bool inlier mask of the best model
    score: jnp.ndarray     # [] best score
    n_inliers: jnp.ndarray # [] int


def sample_minimal_sets(key: jax.Array, n_points: int, weights: jnp.ndarray,
                        n_samples: int, sample_size: int) -> jnp.ndarray:
    """[n_samples, sample_size] indices drawn ~uniformly from valid points.

    Uses Gumbel top-k per hypothesis over the weight mask: guarantees
    distinct indices within a set (the reference deduplicates by drawing
    without replacement, initialization.cpp:52-62) and never picks masked
    rows while keeping everything statically shaped.
    """
    logits = jnp.where(weights > 0, 0.0, -1e30)  # uniform over valid
    g = jax.random.gumbel(key, (n_samples, n_points)) + logits[None, :]
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


def ransac(key: jax.Array,
           fit: Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], jnp.ndarray],
           score: Callable[[jnp.ndarray], tuple],
           p1: jnp.ndarray, p2: jnp.ndarray, weights: jnp.ndarray,
           n_samples: int, sample_size: int,
           refit: Callable | None = None, refit_rounds: int = 1) -> RansacResult:
    """Generic vmapped RANSAC over fixed-capacity matches.

    fit(p1_s, p2_s, w_s) -> model for a minimal set;
    score(model) -> (score_scalar, inlier_mask) over all matches;
    refit(model, inliers) -> model, optional least-squares polish on the
    best hypothesis' inliers (reference Stitch::least_squares_fit,
    src/stitch.cpp:187-218). ``refit_rounds > 1`` iterates
    refit -> re-gate inliers -> refit (LO-RANSAC style), which removes most
    of the sampling-seed variance of the minimal-set winner.
    """
    n = p1.shape[0]
    idx = sample_minimal_sets(key, n, weights, n_samples, sample_size)

    def one(sample_idx):
        s1 = p1[sample_idx]
        s2 = p2[sample_idx]
        sw = jnp.ones((sample_size,), p1.dtype)
        model = fit(s1, s2, sw)
        sc, inl = score(model)
        return model, sc, inl

    models, scores, inls = jax.vmap(one)(idx)
    best = jnp.argmax(scores)
    model = jax.tree.map(lambda m: m[best], models)
    inliers = inls[best]
    final_score = scores[best]
    if refit is not None:
        for _ in range(refit_rounds):
            model2 = refit(model, inliers)
            sc2, inl2 = score(model2)
            better = sc2 >= final_score
            model = jnp.where(better, model2, model)
            inliers = jnp.where(better, inl2, inliers)
            final_score = jnp.where(better, sc2, final_score)
    return RansacResult(model=model, inliers=inliers, score=final_score,
                        n_inliers=jnp.sum(inliers.astype(jnp.int32)))


# ---------------------------------------------------------------------------
# concrete front-ends
# ---------------------------------------------------------------------------

def ransac_homography(key: jax.Array, src: jnp.ndarray, dst: jnp.ndarray,
                      weights: jnp.ndarray, n_samples: int = 500,
                      threshold: float = 5.0, translate_only: bool = False) -> RansacResult:
    """Homography RANSAC with stitch-parity semantics (src/stitch.cpp:101-153):
    minimal sets of 4 (homography) or 1 (translation), forward-transfer
    inlier test at ``threshold`` px, least-squares refit on inliers."""
    sample_size = 1 if translate_only else 4

    def fit(s1, s2, sw):
        if translate_only:
            return homography.fit_translation(s1, s2, sw)
        return homography.fit_homography(s1, s2, sw)

    def score(H):
        err = homography.transfer_error(H, src, dst)
        inl = (err < threshold) & (weights > 0)
        return jnp.sum(inl.astype(jnp.float32)), inl

    def refit(H, inl):
        w = inl.astype(src.dtype)
        if translate_only:
            return homography.fit_translation(src, dst, w)
        return homography.fit_homography(src, dst, w)

    return ransac(key, fit, score, src, dst, weights, n_samples, sample_size, refit)


def ransac_fundamental(key: jax.Array, p1: jnp.ndarray, p2: jnp.ndarray,
                       weights: jnp.ndarray, n_samples: int = 200,
                       sigma: float = 1.0) -> RansacResult:
    """Normalized 8-point F RANSAC with chi-square scoring — initializer
    parity (FindFundamental, src/initialization.cpp:81-133: 200 models,
    MAD normalization, symmetric chi2 with th=3.841/thScore=5.991)."""

    def fit(s1, s2, sw):
        return epipolar.fit_fundamental(s1, s2, sw, normalize="mad")

    def score(F):
        return epipolar.score_fundamental(F, p1, p2, weights.astype(p1.dtype), sigma=sigma)

    def refit(F, inl):
        return epipolar.fit_fundamental(p1, p2, inl.astype(p1.dtype), normalize="mad")

    return ransac(key, fit, score, p1, p2, weights, n_samples, 8, refit,
                  refit_rounds=3)
