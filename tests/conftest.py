"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding logic (distributed BA, mesh collectives) is tested
without accelerators via XLA's host-platform device-count override. The
XLA flag must be set before jax initializes; the platform is forced to the
CPU through jax.config so an installed GPU plugin never picks the tests
up.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# f32 matmuls must be real f32 in geometry code (lower precision is opted
# into explicitly where wanted, never silently in tests).
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_IMGS = "/root/reference/imgs"


def pytest_configure(config):
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
    assert jax.device_count() >= 8, "expected 8 virtual CPU devices"


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_memory():
    """Drop compiled-executable caches after every test module.

    XLA:CPU compilation memory accumulates monotonically over the suite
    (~6 GB RSS by mid-suite) and eventually SIGSEGVs the single-process
    run (round-2 verdict). Modules rarely share compiled programs, so
    clearing at module boundaries bounds RSS at negligible recompile
    cost."""
    yield
    jax.clear_caches()


@pytest.fixture()
def rng(request):
    # fresh deterministic generator per test: no order dependence; seed
    # derived from the test name so different tests see different scenes
    import zlib

    seed = zlib.crc32(request.node.name.encode())  # stable across processes
    return np.random.default_rng(seed)


@pytest.fixture(scope="session")
def kitti_pair():
    """Two consecutive KITTI grayscale frames (fixture data from the
    reference's checked-in imgs/, used as input data only)."""
    from PIL import Image

    f0 = os.path.join(REFERENCE_IMGS, "kitti0.png")
    f1 = os.path.join(REFERENCE_IMGS, "kitti1.png")
    if not (os.path.exists(f0) and os.path.exists(f1)):
        pytest.skip("reference KITTI fixtures not available")
    a = np.asarray(Image.open(f0).convert("L"), dtype=np.float32) / 255.0
    b = np.asarray(Image.open(f1).convert("L"), dtype=np.float32) / 255.0
    return a, b


@pytest.fixture(scope="session")
def kitti_seq():
    """All ten consecutive KITTI frames kitti0..kitti9 as one [10, H, W]."""
    from PIL import Image

    paths = [os.path.join(REFERENCE_IMGS, f"kitti{i}.png") for i in range(10)]
    if not all(os.path.exists(p) for p in paths):
        pytest.skip("reference KITTI fixtures not available")
    frames = [np.asarray(Image.open(p).convert("L"), dtype=np.float32) / 255.0
              for p in paths]
    return np.stack(frames)
