"""Corner response (FAST-10 + 3x3 NMS + Shi-Tomasi, ops/corners.py)
against the float64 numpy reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from dr3_tpu.ops import corners
from tests import npref


def reference(img, t):
    return np.where(npref.nms3x3(npref.fast_score(img, t)),
                    npref.shi_tomasi(img), 0.0)


def assert_same_response(got, want):
    """Same corner set exactly (FAST and NMS compare differences of the
    same pixel values, so f32 and f64 agree); scores to a loose tolerance
    (0.5*(tr - sqrt(tr^2-4det)) amplifies f32 rounding)."""
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.05)


def _response(img, t=20.0):
    return np.asarray(corners.corner_response(jnp.asarray(img), t))


@pytest.mark.parametrize("hw", [(32, 32), (64, 96), (56, 200), (96, 130)])
def test_matches_reference_random(rng, hw):
    img = rng.uniform(0, 1, hw).astype(np.float32)
    assert_same_response(_response(img), reference(img, 20.0))


def test_matches_reference_structured(rng):
    # rectangles + dots: real corners with nonzero scores
    img = np.zeros((72, 160), np.float32)
    img[20:50, 30:90] = 0.8
    img[10:14, 120:150] = 0.5
    for _ in range(20):
        y, x = rng.integers(6, 66), rng.integers(6, 154)
        img[y, x] = 1.0
    want = reference(img, 20.0)
    assert (want > 0).sum() > 4  # the scenario actually produces corners
    assert_same_response(_response(img), want)


def test_zero_outside_inner_border(rng):
    got = _response(rng.uniform(0, 1, (48, 136)).astype(np.float32))
    assert (got[:5] == 0).all() and (got[-5:] == 0).all()
    assert (got[:, :5] == 0).all() and (got[:, -5:] == 0).all()


def test_fast_score_matches_reference(rng):
    img = rng.uniform(0, 1, (130, 140)).astype(np.float32)
    got = np.asarray(corners.fast_score_map(jnp.asarray(img), 10.0))
    np.testing.assert_allclose(got, npref.fast_score(img, 10.0), atol=1e-3)
