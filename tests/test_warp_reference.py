"""Dense warps (ops/warp.py) against float64 numpy references.

Anchors: single-axis remaps and shifts reproduce direct bilinear sampling;
spherical / cylindrical / perspective warps sample where the float64 field
says; bilinear reproduces affine images exactly. Pixels whose float64
source coordinate sits within 1e-3 px of the image border are left out of
value comparisons: f32 and f64 may disagree on their validity.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dr3_tpu.ops import warp
from tests import npref

H, W = 93, 201


def _img(rng, h=H, w=W):
    return rng.uniform(0, 1, (h, w)).astype(np.float32)


def _grid(h=H, w=W):
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    return gx, gy


def _remap(img, u, v):
    return np.asarray(warp.remap(jnp.asarray(img), jnp.asarray(u),
                                 jnp.asarray(v)))


def _clear_of_border(u, v, h, w, margin=1e-3):
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    inside = (u >= margin) & (v >= margin) & (u <= w - 1 - margin) \
        & (v <= h - 1 - margin)
    outside = (u < -margin) | (v < -margin) | (u > w - 1 + margin) \
        | (v > h - 1 + margin)
    return inside | outside


class TestSingleAxisRemaps:
    def test_identity_rows_exact(self, rng):
        img = _img(rng)
        gx, gy = _grid()
        np.testing.assert_array_equal(_remap(img, gx, gy), img)

    def test_identity_cols_exact(self, rng):
        img = _img(rng)
        gx, gy = _grid()
        out, valid = warp.bilinear_sample(jnp.asarray(img),
                                          jnp.stack([gx, gy], -1))
        np.testing.assert_array_equal(np.asarray(out), img)
        assert bool(np.asarray(valid).all())

    @pytest.mark.parametrize("shift", [3.25, -7.6, 0.5])
    def test_row_shift_matches_reference(self, rng, shift):
        img = _img(rng)
        gx, gy = _grid()
        v = np.clip(gy + shift, 0, H - 1)
        want, _ = npref.bilinear(img, gx, v)
        np.testing.assert_allclose(_remap(img, gx, v), want, atol=1e-5)

    @pytest.mark.parametrize("shift", [3.25, -7.6, 0.5])
    def test_col_shift_matches_reference(self, rng, shift):
        img = _img(rng)
        gx, gy = _grid()
        u = np.clip(gx + shift, 0, W - 1)
        want, _ = npref.bilinear(img, u, gy)
        np.testing.assert_allclose(_remap(img, u, gy), want, atol=1e-5)

    def test_smooth_varying_field(self, rng):
        img = _img(rng)
        gx, gy = _grid()
        v = np.clip(gy + 4.0 * np.sin(gx / 30.0), 0, H - 1).astype(np.float32)
        want, _ = npref.bilinear(img, gx, v)
        np.testing.assert_allclose(_remap(img, gx, v), want, atol=1e-5)

    def test_far_out_of_bounds_does_not_poison_neighbors(self, rng):
        """Far-out coordinates read as fill; in-range neighbours stay
        exact."""
        img = _img(rng)
        gx, gy = _grid()
        v = np.where(gx > 150.0, 5000.0, gy + 2.5).astype(np.float32)
        out = _remap(img, gx, v)
        want, valid = npref.bilinear(img, gx, v)
        assert not valid[:, 151:].any()
        assert (out[:, 151:] == 0).all()
        keep = (gx <= 150.0) & (gy + 2.5 <= H - 1)
        np.testing.assert_allclose(out[keep], want[keep], atol=1e-5)


class TestSphericalCylindrical:
    def _field(self, kind, f, h=H, w=W):
        gx, gy = _grid(h, w)
        a = (gx.astype(np.float64) - 0.5 * w) / f
        b = (gy.astype(np.float64) - 0.5 * h) / f
        if kind == "spherical":
            xh, yh, zh = np.sin(a) * np.cos(b), np.sin(b), np.cos(a) * np.cos(b)
        else:
            xh, yh, zh = np.sin(a), b, np.cos(a)
        return 0.5 * w + f * xh / zh, 0.5 * h + f * yh / zh

    @pytest.mark.parametrize("f", [150.0, 300.0])
    def test_spherical_matches_reference(self, rng, f):
        img = _img(rng)
        u, v = self._field("spherical", f)
        want, _ = npref.bilinear(img, u, v)
        got = np.asarray(warp.warp_spherical(jnp.asarray(img), f))
        m = _clear_of_border(u, v, H, W)
        np.testing.assert_allclose(got[m], want[m], atol=1e-3)

    def test_cylindrical_matches_reference(self, rng):
        img = _img(rng)
        u, v = self._field("cylindrical", 150.0)
        want, _ = npref.bilinear(img, u, v)
        got = np.asarray(warp.warp_cylindrical(jnp.asarray(img), 150.0))
        m = _clear_of_border(u, v, H, W)
        np.testing.assert_allclose(got[m], want[m], atol=1e-3)


def _perspective_ref(img, Hm, out_hw):
    oh, ow = out_hw
    gx, gy = _grid(oh, ow)
    p = np.stack([gx, gy, np.ones_like(gx)], -1).astype(np.float64)
    s = p @ np.linalg.inv(np.asarray(Hm, np.float64)).T
    u, v = s[..., 0] / s[..., 2], s[..., 1] / s[..., 2]
    out, valid = npref.bilinear(img, u, v)
    return out, valid, _clear_of_border(u, v, *img.shape[:2])


class TestPerspective:
    H1 = np.asarray([[1.02, 0.03, 4.0], [-0.02, 0.98, -2.5],
                     [1e-5, -2e-5, 1.0]], np.float32)
    H2 = np.asarray([[0.98, 0.05, 60.0], [-0.04, 1.01, 8.0],
                     [2e-5, 1e-5, 1.0]], np.float32)

    def test_ramp_exact(self):
        """Bilinear reproduces an affine image exactly."""
        gx, gy = _grid()
        ramp = (0.3 * gx + 0.5 * gy).astype(np.float32)
        out, valid = warp.warp_perspective(jnp.asarray(ramp),
                                           jnp.asarray(self.H1), (H, W))
        want, vref, m = _perspective_ref(ramp, self.H1, (H, W))
        m = m & vref
        np.testing.assert_array_equal(np.asarray(valid)[m], vref[m])
        np.testing.assert_allclose(np.asarray(out)[m], want[m], atol=5e-3)

    @pytest.mark.parametrize("Hm,out_hw", [(H1, (93, 201)), (H2, (120, 260))])
    def test_noise_image_matches_reference(self, rng, Hm, out_hw):
        img = _img(rng)
        out, valid = warp.warp_perspective(jnp.asarray(img),
                                           jnp.asarray(Hm), out_hw)
        want, vref, m = _perspective_ref(img, Hm, out_hw)
        np.testing.assert_array_equal(np.asarray(valid)[m], vref[m])
        np.testing.assert_allclose(np.asarray(out)[m], want[m], atol=1e-3)

    def test_rgb_matches_gray_per_channel(self, rng):
        rgb = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
        out, valid = warp.warp_perspective(rgb, jnp.asarray(self.H1), (H, W))
        for c in range(3):
            oc, vc = warp.warp_perspective(rgb[..., c], jnp.asarray(self.H1),
                                           (H, W))
            np.testing.assert_array_equal(np.asarray(out[..., c]),
                                          np.asarray(oc))
            assert bool(jnp.all(valid == vc))

    def test_horizon_in_canvas_reads_invalid(self, rng):
        """A homography whose horizon crosses the canvas maps rows beyond
        it to far-away (or behind-camera) sources: they must read as
        invalid fill, never as NaN."""
        img = _img(rng)
        Hbad = np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                           [0.0, 0.01, 1.0]], np.float32)
        out, valid = warp.warp_perspective(jnp.asarray(img),
                                           jnp.asarray(Hbad), (300, W))
        want, vref, m = _perspective_ref(img, Hbad, (300, W))
        out = np.asarray(out)
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(np.asarray(valid)[m], vref[m])
        assert (out[~np.asarray(valid)] == 0).all()


class TestAffineAndFill:
    def test_affine_matches_reference(self, rng):
        img = _img(rng)
        M = np.asarray([[0.97, 0.04, 5.5], [-0.03, 1.02, -3.25]], np.float32)
        out, valid = warp.warp_affine(jnp.asarray(img), jnp.asarray(M),
                                      (H, W))
        Hm = np.vstack([M, [0.0, 0.0, 1.0]])
        want, vref, m = _perspective_ref(img, Hm, (H, W))
        np.testing.assert_array_equal(np.asarray(valid)[m], vref[m])
        np.testing.assert_allclose(np.asarray(out)[m], want[m], atol=1e-3)

    def test_fill_value_outside(self, rng):
        img = _img(rng)
        gx, gy = _grid()
        out, valid = warp.bilinear_sample(
            jnp.asarray(img), jnp.stack([gx - 100.0, gy], -1), fill=-1.0)
        want, vref = npref.bilinear(img, gx - 100.0, gy, fill=-1.0)
        np.testing.assert_array_equal(np.asarray(valid), vref)
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)
