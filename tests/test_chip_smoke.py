"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases runs end to end at a tiny size with the CPU standing in for the
card (the comparisons then hold trivially; what is tested is the path)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = chip_smoke.Sizes(
    width=320, height=240, fx=280.0, cx=160.0, cy=120.0, vo_frames=32,
    vo_overrides=(("init_min_features", 60), ("init_min_tracked", 60),
                  ("init_min_triangulated", 30), ("init_min_disparity", 2.0),
                  ("kf_disparity", 10.0), ("max_keyframes", 16),
                  ("loop_db_capacity", 32), ("loop_min_gap_frames", 12),
                  ("frames_per_dispatch", 4)),
    window=(6, 400, 60), window_iters=4, bal=(6, 300, 80), bal_iters=4,
    bal_cpu_iters=2, pano_views=3, pano_width=240, pano_height=180,
    pano_f=220.0)


@pytest.fixture()
def cpu():
    return jax.devices("cpu")[0]


def test_refuses_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_phase_ops(cpu):
    out = chip_smoke.phase_ops(cpu, cpu, TINY, np.random.default_rng(0))
    assert out["LK_ok"] > 20 and out["corners"] > 0


def test_phase_ba(cpu):
    out = chip_smoke.phase_ba(cpu, cpu, TINY, np.random.default_rng(0))
    assert out["window_rel"] == 0.0 and out["bal_rel"] == 0.0


def test_phase_panorama(cpu):
    out = chip_smoke.phase_panorama(cpu, cpu, TINY, np.random.default_rng(0))
    assert out["canvas"][0] >= TINY.pano_height
