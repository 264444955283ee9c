"""The synthetic renderer is importable from the package, and the test
suite's re-export is the same code."""

import numpy as np

import tests.synth
from dr3_tpu.io import synth


def test_renderer_from_package_path(rng):
    assert tests.synth.render_scene is synth.render_scene
    poses = synth.out_and_back_poses(8)
    centers = np.stack([p.center() for p in poses])
    assert np.allclose(centers[0], 0) and np.abs(centers).max() > 1.0
    from types import SimpleNamespace

    cam = SimpleNamespace(width=64, height=48, fx=50.0, fy=50.0, cx=32.0,
                          cy=24.0)
    frames = synth.render_sequence(cam, poses[:2], rng, texture_size=256)
    assert frames[0].shape == (48, 64) and frames[0].dtype == np.float32
    assert 0.0 <= frames[0].min() and frames[0].max() <= 1.0
    assert np.abs(frames[0] - frames[1]).mean() > 1e-3
