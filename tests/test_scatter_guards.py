"""Guards on the dense square-root Schur scatters (ba/schur_core.py,
ba/snavely.py): int32 flat indexing under promise_in_bounds, and the
dense-size fallback of the zexplicit correction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dr3_tpu.ba import schur_core
from dr3_tpu.ba.schur_core import (_explicit_s_corr_sqrt,
                                   check_flat_scatter_size)


def test_flat_scatter_past_int32_refused_at_trace_time():
    check_flat_scatter_size(2 ** 31 - 1)
    with pytest.raises(ValueError, match="int32"):
        check_flat_scatter_size(2 ** 31)
    # traced with abstract shapes only: nothing of the 2^31-element Z is
    # allocated before the guard refuses it
    K, C, O = 64, 6, 16
    P = 2 ** 31 // (3 * C * K) + 1
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((P, 3, 3), f32),
            jax.ShapeDtypeStruct((O, C, 3), f32),
            jax.ShapeDtypeStruct((O,), jnp.int32),
            jax.ShapeDtypeStruct((O,), jnp.int32))
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(lambda *a: _explicit_s_corr_sqrt(*a, K, P), *args)


def test_zexplicit_falls_back_past_dense_ceiling(rng, monkeypatch):
    """Past _DENSE_W_MAX_ELEMS the zexplicit method takes the pair-table
    path like explicit does, and solves the same system."""
    from tests.test_ba import synthetic_ba
    from dr3_tpu.ba.problem import linearize

    prob, _, _ = synthetic_ba(rng, n_cams=5, n_pts=96, noise_px=0.3)
    res = linearize(prob, 5.0)
    blocks = schur_core.assemble_blocks(res.r, res.Jc, res.Jp, prob.obs_cam,
                                        prob.obs_pt, res.valid, prob.n_cams,
                                        prob.n_points)
    fixed = jnp.zeros(prob.n_cams, bool).at[0].set(True)
    want = schur_core.solve_schur(blocks, 1e-3, fixed, method="zexplicit")

    def no_sqrt(*a, **k):
        raise AssertionError("sqrt correction used past the ceiling")
    monkeypatch.setattr(schur_core, "_DENSE_W_MAX_ELEMS", 0)
    monkeypatch.setattr(schur_core, "_explicit_s_corr_sqrt", no_sqrt)
    got = schur_core.solve_schur(blocks, 1e-3, fixed, method="zexplicit")
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-3, atol=1e-5)
