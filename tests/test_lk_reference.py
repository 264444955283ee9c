"""Pyramidal LK, template align and patch sampling (ops/lk.py,
ops/sparse_align.py) against float64 numpy references."""

import jax.numpy as jnp
import numpy as np
from scipy import ndimage

from dr3_tpu.ops import lk, pyramid
from dr3_tpu.ops.sparse_align import _sample_patches
from tests import npref


def smooth(rng, h=128, w=160, sigma=3.0):
    return ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)),
                                   sigma).astype(np.float32)


def _pair(rng, shift, h=128, w=160, levels=3):
    img = smooth(rng, h, w)
    img2 = ndimage.shift(img, shift, order=1, mode="nearest").astype(np.float32)
    return (pyramid.build_pyramid(jnp.asarray(img), levels),
            pyramid.build_pyramid(jnp.asarray(img2), levels))


def _grid_pts(x0, x1, y0, y1, step):
    return np.stack(np.meshgrid(np.arange(x0, x1, step),
                                np.arange(y0, y1, step)),
                    -1).reshape(-1, 2).astype(np.float32)


def test_track_pyramid_matches_float64_reference(rng):
    p1, p2 = _pair(rng, (2.3, -1.7))
    pts = _grid_pts(30, 130, 30, 98, 16)
    v = np.ones(len(pts), bool)
    got = lk.track_pyramid(p1, p2, jnp.asarray(pts), jnp.asarray(v),
                           half_window=7, iters=15)
    pos, ok, _ = npref.track_pyramid([np.asarray(a) for a in p1],
                                     [np.asarray(a) for a in p2],
                                     pts, v, half=7, iters=15, eps=1e-2)
    both = np.asarray(got.ok) & ok
    assert both.mean() > 0.8
    assert (np.asarray(got.ok) == ok).mean() > 0.95
    assert np.abs(np.asarray(got.pos)[both] - pos[both]).max() < 1e-2


def test_recovers_known_shift(rng):
    shift = (4.6, -3.1)
    p1, p2 = _pair(rng, shift, 160, 192)
    pts = _grid_pts(40, 150, 40, 120, 20)
    res = lk.track_pyramid(p1, p2, jnp.asarray(pts),
                           jnp.ones(len(pts), bool), half_window=7, iters=12)
    ok = np.asarray(res.ok)
    flow = np.asarray(res.pos) - pts
    assert ok.mean() > 0.8
    np.testing.assert_allclose(flow[ok].mean(0), [shift[1], shift[0]],
                               atol=0.15)


def test_flat_region_rejected():
    pyr = pyramid.build_pyramid(jnp.full((96, 128), 0.5), 2)
    res = lk.track_pyramid(pyr, pyr, jnp.asarray([[50.0, 50.0]]),
                           jnp.ones(1, bool), half_window=7)
    _, ok, _ = npref.track_pyramid([np.asarray(a) for a in pyr],
                                   [np.asarray(a) for a in pyr],
                                   np.asarray([[50.0, 50.0]]), [True],
                                   half=7, iters=10, eps=1e-2)
    assert not bool(res.ok[0]) and not ok[0]


def test_nonfinite_positions_rejected(rng):
    """NaN/inf/far-out positions (diverged or empty track slots) come back
    ok=False without disturbing the healthy tracks."""
    p1, p2 = _pair(rng, (1.2, -0.8))
    pts = _grid_pts(30, 130, 30, 98, 16)
    bad = pts.copy()
    bad[0] = [np.nan, np.nan]
    bad[1] = [np.inf, -np.inf]
    bad[2] = [-1e9, 1e9]
    bad[3] = [1e4, -1e4]
    v = jnp.ones(len(bad), bool)
    res = lk.track_pyramid(p1, p2, jnp.asarray(bad), v, half_window=7,
                           iters=8)
    clean = lk.track_pyramid(p1, p2, jnp.asarray(pts), v, half_window=7,
                             iters=8)
    ok = np.asarray(res.ok)
    assert not ok[:4].any()
    assert ok[4:].mean() > 0.8
    np.testing.assert_array_equal(np.asarray(res.pos)[4:],
                                  np.asarray(clean.pos)[4:])


def test_extract_patches_matches_reference(rng):
    img = smooth(rng, 96, 160, sigma=1.5)
    pts = rng.uniform([-3, -3], [165, 100], (31, 2)).astype(np.float32)
    got = np.asarray(lk.extract_patches(jnp.asarray(img), jnp.asarray(pts), 4))
    np.testing.assert_allclose(got, npref.patches(img, pts, 4), atol=1e-5)


def test_align_to_templates_recovers_template_positions(rng):
    img = smooth(rng, 160, 192, sigma=2.0)
    true = _grid_pts(40, 150, 40, 120, 18)
    templates = jnp.asarray(npref.patches(img, true, 4).astype(np.float32))
    start = true + rng.uniform(-2.0, 2.0, true.shape).astype(np.float32)
    res = lk.align_to_templates(jnp.asarray(img), templates,
                                jnp.asarray(start),
                                jnp.ones(len(true), bool), iters=10)
    ok = np.asarray(res.ok)
    assert ok.mean() > 0.8
    assert np.abs(np.asarray(res.pos)[ok] - true[ok]).max() < 0.2


def test_sample_patches_matches_reference(rng):
    img = smooth(rng, 96, 160, sigma=1.5)
    pts = rng.uniform([6, 6], [150, 90], (23, 2)).astype(np.float32)
    for half in (2, 3):
        got = np.asarray(_sample_patches(jnp.asarray(img), jnp.asarray(pts),
                                         half))
        np.testing.assert_allclose(got, npref.patches(img, pts, half),
                                   atol=1e-5)
