"""Ablation timing of the on-device VO scan step: which stage costs what
inside the fused lax.scan program (stages behave differently fused vs
dispatched standalone)."""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import entry
    from dr3_tpu.ba.problem import make_problem
    from dr3_tpu.ba.schur_lm import pose_only_adjust
    from dr3_tpu.geometry.lie import SE3
    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.ops import lk, pyramid
    from dr3_tpu.utils.config import Config

    cfg = Config()
    cam = Pinhole.kitti()
    step, args = entry()
    (pyr_prev, img_cur, track_px, track_valid, track_point,
     map_xyz, map_valid, pose_wxyz, pose_t) = args
    rng = np.random.default_rng(0)
    frames = jnp.stack([jnp.asarray(rng.uniform(0, 1, img_cur.shape)
                                    .astype(np.float32)) for _ in range(10)])
    n = 120
    intr = jnp.stack([cam.fx, cam.fy, cam.cx, cam.cy])

    def time_scan(body, init):
        @jax.jit
        def run(frames, init):
            return jax.lax.scan(body, init, jnp.arange(n, dtype=jnp.int32))
        out = run(frames, init)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(5):
            out = run(frames, init)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / (5 * n) * 1e3

    # 1. pyramid only
    def b1(carry, idx):
        img = frames[idx % 10]
        pyr = tuple(pyramid.build_pyramid(img, cfg.klt_levels))
        return carry, pyr[-1].sum()
    print("pyramid only          %7.3f ms" % time_scan(b1, 0.0))

    # 2. pyramid + LK
    def b2(carry, idx):
        pyr_p, px = carry
        img = frames[idx % 10]
        pyr_c = tuple(pyramid.build_pyramid(img, cfg.klt_levels))
        res = lk.track_pyramid(list(pyr_p), list(pyr_c), px, track_valid,
                               half_window=cfg.klt_window // 2,
                               iters=cfg.klt_iters, eps=cfg.klt_eps)
        px2 = jnp.clip(res.pos, jnp.asarray([25.0, 25.0]),
                       jnp.asarray([1215.0, 351.0]))
        return (pyr_c, px2), res.err.sum()
    print("pyramid + LK          %7.3f ms" % time_scan(b2, (pyr_prev, track_px)))

    # 3. pose GN only
    def b3(carry, idx):
        wxyz, t = carry
        prob = make_problem(
            cams=SE3(wxyz[None], t[None]), points=map_xyz,
            intrinsics=intr, obs_cam=jnp.zeros_like(track_point),
            obs_pt=jnp.maximum(track_point, 0), obs_uv=track_px,
            obs_w=jnp.ones((track_px.shape[0],)),
            cam_fixed=jnp.zeros((1,), bool))
        ba = pose_only_adjust(prob, 10, cfg.ba_huber_delta)
        return (ba.problem.cam_wxyz[0], ba.problem.cam_t[0]), ba.final_cost
    print("pose GN only          %7.3f ms" % time_scan(b3, (pose_wxyz, pose_t)))

    # 4. full step
    def b4(carry, idx):
        pyr, px, wxyz, t = carry
        img = frames[idx % 10]
        out = step(pyr, img, px, track_valid, track_point, map_xyz,
                   map_valid, wxyz, t)
        px2 = jnp.clip(out[1], jnp.asarray([25.0, 25.0]),
                       jnp.asarray([1215.0, 351.0]))
        return (out[0], px2, out[3], out[4]), out[5]
    print("full step             %7.3f ms" %
          time_scan(b4, (pyr_prev, track_px, pose_wxyz, pose_t)))


if __name__ == "__main__":
    main()
