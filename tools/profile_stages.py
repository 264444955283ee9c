"""Per-stage device timing of the VO front-end + panorama hot ops.

Times each jitted stage by amortizing over many async dispatches (per-call
synced timing measures dispatch latency). Prints one line per
stage: name, ms/call.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, args, n=60, warmup=2):
    import jax
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from dr3_tpu.ba.problem import make_problem
    from dr3_tpu.ba.schur_lm import pose_only_adjust
    from dr3_tpu.geometry.lie import SE3
    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.ops import corners, lk, pyramid, warp
    from dr3_tpu.utils.config import Config

    cfg = Config()
    cam = Pinhole.kitti()
    h, w = cam.height, cam.width
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    img2 = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))
    n_tracks = 546

    pyr_fn = jax.jit(lambda x: tuple(pyramid.build_pyramid(x, cfg.klt_levels)))
    print("pyramid(4 lvl)        %7.3f ms" % timeit(pyr_fn, (img,)))

    pyr1 = pyr_fn(img)
    pyr2 = pyr_fn(img2)
    px = jnp.asarray(rng.uniform([20, 20], [w - 20, h - 20],
                                 (n_tracks, 2)).astype(np.float32))
    valid = jnp.ones((n_tracks,), bool)

    lk_fn = jax.jit(lambda a, b, p, v: lk.track_pyramid(
        list(a), list(b), p, v, half_window=cfg.klt_window // 2,
        iters=cfg.klt_iters, eps=cfg.klt_eps))
    print("LK (4lvl,10it)        %7.3f ms" % timeit(lk_fn, (pyr1, pyr2, px, valid)))

    det_fn = jax.jit(lambda pyr: corners.detect_features(
        list(pyr)[: cfg.n_pyr_levels], cfg.cell_size, cfg.min_corner_score,
        cfg.fast_threshold))
    try:
        print("FAST+ST detect        %7.3f ms" % timeit(det_fn, (pyr1,)))
    except Exception as e:
        print("FAST+ST detect        FAILED:", type(e).__name__, e)

    intr = jnp.stack([cam.fx, cam.fy, cam.cx, cam.cy])
    map_xyz = jnp.asarray(np.stack([
        rng.uniform(-5, 5, 2048), rng.uniform(-2, 2, 2048),
        rng.uniform(4, 30, 2048)], -1).astype(np.float32))
    tp = jnp.arange(n_tracks, dtype=jnp.int32)

    def gn(pos, px):
        prob = make_problem(
            cams=SE3(jnp.asarray([[1.0, 0, 0, 0]]), jnp.zeros((1, 3))),
            points=map_xyz, intrinsics=intr, obs_cam=jnp.zeros_like(tp),
            obs_pt=tp, obs_uv=pos, obs_w=jnp.ones((n_tracks,)),
            cam_fixed=jnp.zeros((1,), bool))
        ba = pose_only_adjust(prob, 10, cfg.ba_huber_delta)
        return ba.problem.cam_t[0]

    gn_fn = jax.jit(gn)
    print("pose GN (10 it)       %7.3f ms" % timeit(gn_fn, (px, px)))

    Hm = jnp.asarray([[1.0, 0.01, 5.0], [-0.01, 1.0, 3.0], [1e-5, 0, 1.0]])
    wp_fn = jax.jit(lambda im: warp.warp_perspective(im, Hm, (h, w))[0])
    print("warp_perspective      %7.3f ms" % timeit(wp_fn, (img,)))

    sph_fn = jax.jit(lambda im: warp.warp_spherical(im, 700.0))
    print("warp_spherical        %7.3f ms" % timeit(sph_fn, (img,)))

    rgb = jnp.asarray(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    wp3_fn = jax.jit(lambda im: warp.warp_perspective(im, Hm, (h, w))[0])
    print("warp_perspective rgb  %7.3f ms" % timeit(wp3_fn, (rgb,)))


if __name__ == "__main__":
    main()
