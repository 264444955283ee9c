"""True multi-process distributed BA: 2 OS processes, jax.distributed over
local TCP, a 2-level [hosts, points] mesh spanning both — the CPU stand-in
for a multi-host cluster (SURVEY §7 config 5). Verifies the N-process
solve equals the single-process solve."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys, json
pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from dr3_tpu.parallel.mesh import distributed_init
assert distributed_init(f"127.0.0.1:{port}", n, pid)
assert jax.process_count() == n
assert jax.device_count() == 2 * n

import numpy as np
import jax.numpy as jnp
from dr3_tpu.ba.problem import make_problem, project
from dr3_tpu.geometry.lie import SE3
from dr3_tpu.parallel.dist_ba import dist_bundle_adjust
from dr3_tpu.parallel.mesh import make_mesh_2d

# identical deterministic problem on every process
rng = np.random.default_rng(1234)
n_cams, n_pts = 5, 96
intr = jnp.asarray([500.0, 500.0, 320.0, 240.0])
pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                rng.uniform(7, 14, n_pts)], -1).astype(np.float32)
taus = np.zeros((n_cams, 6), np.float32)
taus[:, 0] = 0.35 * np.arange(n_cams)
cams = SE3.exp(jnp.asarray(taus))
obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
uv = np.array(project(intr, cams[obs_cam].apply(jnp.asarray(pts)[obs_pt])))
uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
prob = make_problem(cams, pts0, intr, obs_cam, obs_pt, uv)

mesh = make_mesh_2d()  # [n processes (DCN), 2 local devices (ICI)]
assert mesh.devices.shape == (n, 2)
res = dist_bundle_adjust(prob, max_iters=10, mesh=mesh)
out = {
    "pid": pid,
    "initial": float(res.initial_cost),
    "final": float(res.final_cost),
    "cam_t": np.asarray(res.problem.cam_t).tolist(),
    "pts_sum": float(np.abs(np.asarray(res.problem.points)).sum()),
}
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.mark.slow
def test_two_process_dist_ba_matches_single_process(tmp_path):
    import jax.numpy as jnp

    from dr3_tpu.ba.problem import make_problem, project
    from dr3_tpu.ba.schur_lm import bundle_adjust
    from dr3_tpu.geometry.lie import SE3

    # single-process oracle: the same deterministic problem
    rng = np.random.default_rng(1234)
    n_cams, n_pts = 5, 96
    intr = jnp.asarray([500.0, 500.0, 320.0, 240.0])
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(7, 14, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 0] = 0.35 * np.arange(n_cams)
    cams = SE3.exp(jnp.asarray(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.array(project(intr, cams[obs_cam].apply(jnp.asarray(pts)[obs_pt])))
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    prob = make_problem(cams, pts0, intr, obs_cam, obs_pt, uv)
    single = bundle_adjust(prob, 10)

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        line = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert line, out
        outs.append(json.loads(line[-1][len("RESULT "):]))

    # both processes agree with each other and with the single-process solve
    np.testing.assert_allclose(outs[0]["final"], outs[1]["final"], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["initial"], float(single.initial_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(outs[0]["final"], float(single.final_cost),
                               rtol=0.05)
    np.testing.assert_allclose(np.asarray(outs[0]["cam_t"]),
                               np.asarray(single.problem.cam_t), atol=1e-2)


_VO_WORKER = r"""
import os, sys, json
pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from dr3_tpu.parallel.mesh import distributed_init, make_mesh_2d
assert distributed_init(f"127.0.0.1:{port}", n, pid)
assert jax.process_count() == n

import numpy as np
from types import SimpleNamespace
from dr3_tpu.models.camera import Pinhole
from dr3_tpu.pipelines.vo import MonoVO, Stage
from dr3_tpu.utils.config import Config
from tests.synth import NpSE3, make_textures, render_scene

rng = np.random.default_rng(0)
w, h = 240, 180
f = 0.875 * w
host_cam = SimpleNamespace(width=w, height=h, fx=f, fy=f, cx=w/2.0, cy=h/2.0)
cam = Pinhole.create(w, h, f, f, w/2.0, h/2.0)
tn, tf = make_textures(rng, size=800)
frames = []
for i in range(14):
    tau = np.asarray([-0.09*i, 0.0, 0.0, 0.0, 0.01*i, 0.0], np.float32)
    frames.append(np.asarray(render_scene(host_cam, NpSE3.exp(tau), tn, tf)))

cfg = Config(init_min_features=40, init_min_tracked=40,
             init_min_triangulated=25, init_min_disparity=2.0,
             kf_disparity=8.0, max_keyframes=8, loop_closure=False)
mesh = make_mesh_2d()          # [n processes (DCN), 2 local devices (ICI)]
assert mesh.devices.shape == (n, 2)
vo = MonoVO(cam, cfg, mesh=mesh)
for img in frames:
    vo.process(img)
assert vo.stage is Stage.GENERAL, vo.stage
n_kf = sum(1 for s in vo.stats if s.is_keyframe)
out = {"pid": pid, "n_kf": n_kf,
       "positions": vo.positions().tolist()}
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.mark.slow
def test_two_process_vo_driver_matches_single(tmp_path):
    """The FULL MonoVO driver with a 2-process 2-level mesh (window BA
    sharded across a process boundary) must reproduce the single-process
    trajectory — the last untested seam of SURVEY §7 config 5 (round-3
    verdict item 8)."""
    from types import SimpleNamespace

    import jax

    jax.config.update("jax_platforms", "cpu")
    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.pipelines.vo import MonoVO, Stage
    from dr3_tpu.utils.config import Config
    from tests.synth import NpSE3, make_textures, render_scene

    rng = np.random.default_rng(0)
    w, h = 240, 180
    f = 0.875 * w
    host_cam = SimpleNamespace(width=w, height=h, fx=f, fy=f,
                               cx=w / 2.0, cy=h / 2.0)
    cam = Pinhole.create(w, h, f, f, w / 2.0, h / 2.0)
    tn, tf = make_textures(rng, size=800)
    frames = []
    for i in range(14):
        tau = np.asarray([-0.09 * i, 0.0, 0.0, 0.0, 0.01 * i, 0.0],
                         np.float32)
        frames.append(np.asarray(render_scene(host_cam, NpSE3.exp(tau),
                                              tn, tf)))
    cfg = Config(init_min_features=40, init_min_tracked=40,
                 init_min_triangulated=25, init_min_disparity=2.0,
                 kf_disparity=8.0, max_keyframes=8, loop_closure=False)
    vo_s = MonoVO(cam, cfg)
    for img in frames:
        vo_s.process(img)
    assert vo_s.stage is Stage.GENERAL
    p_single = vo_s.positions()

    worker = tmp_path / "vo_worker.py"
    worker.write_text(_VO_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-2000:]}"
        line = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert line, out
        outs.append(json.loads(line[-1][len("RESULT "):]))

    for o in outs:
        assert o["n_kf"] >= 3
        np.testing.assert_allclose(np.asarray(o["positions"]), p_single,
                                   atol=5e-3)
    np.testing.assert_allclose(np.asarray(outs[0]["positions"]),
                               np.asarray(outs[1]["positions"]), atol=1e-6)
