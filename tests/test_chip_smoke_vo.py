"""chip_smoke.py's VO phases on the CPU at a tiny size: the batched driver
against ground truth and the per-frame driver, and the mesh-attached
driver with distributed BA on four of the virtual CPU devices."""

import jax
import numpy as np
import pytest

import chip_smoke
from tests.test_chip_smoke import TINY


@pytest.fixture()
def cpu():
    return jax.devices("cpu")[0]


def test_phase_vo(cpu):
    out = chip_smoke.phase_vo(cpu, TINY, np.random.default_rng(0))
    assert out["keyframes"] >= 3 and out["scan_window_bas"] >= 1


def test_phase_four_cards():
    out = chip_smoke.phase_four_cards(TINY, np.random.default_rng(0))
    assert out["dist_ba_rel"] < 5e-2
