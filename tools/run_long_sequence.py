"""Full-pipeline evidence run: a LONG synthetic sequence with ground truth.

The north-star metric (BASELINE.md) is "frames/sec/chip on KITTI seq-00 at
reference ATE". This bench environment has no dataset egress — only the ten
KITTI frames checked into the reference — so, per the baseline protocol,
this tool *generates* a 500+-frame sequence with exact ground truth (the
same renderer the test suite uses: two textured planes, lateral sweeps with
gentle yaw) and runs the COMPLETE MonoVO driver over it: detection,
tracking, pose optimization, keyframing, triangulation, window BA, map
compaction, loop closure, relocalization. Reports wall-clock pipeline
frames/sec (all keyframe stages included), Sim(3) ATE against ground truth,
and the long-horizon counters (compactions, loop closures, database ring
compactions).

    python tools/run_long_sequence.py --frames 500 [--cpu] [--kitti-res]

Prints one JSON line at the end for easy capture.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_sequence(n_frames: int, width: int, height: int, rng,
                  profile: str = "lateral"):
    """Ground-truth poses + rendered frames.

    ``profile``:
    * ``lateral`` — out-and-back sweeps (several periods -> revisits for
      loop closure) with gentle yaw wobble: maximal-parallax geometry.
    * ``forward`` — KITTI-like forward-dominant driving down an endless
      textured corridor with S-curve turns and one rotation-only stress
      segment (zero parallax while it lasts) — the regime the reference
      demonstrates (reference README.md:4-5), where parallax vanishes
      near the focus of expansion.

    Pose math and rendering are pure numpy (NpSE3), so the frames are
    made on the host before the pipeline starts."""
    from scipy import ndimage

    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.io.synth import (NpSE3, corridor_path, make_textures,
                                  render_corridor, render_scene)

    from types import SimpleNamespace

    f = 0.875 * width
    # one dict of plain floats feeds BOTH the device camera (Pinhole.create)
    # and the renderer's host-side view, so they cannot disagree if create's
    # conventions ever change
    intr = dict(width=width, height=height, fx=f, fy=f,
                cx=width / 2.0, cy=height / 2.0)
    cam = Pinhole.create(intr["width"], intr["height"], intr["fx"],
                         intr["fy"], intr["cx"], intr["cy"])
    # plain-float camera view for the renderer: float(cam.fx) on a device
    # Pinhole is a device fetch per access, 4x per frame
    host_cam = SimpleNamespace(**intr)

    if profile == "forward":
        tex_g, tex_w = make_textures(rng, size=800)
        # soften the tile so far-field texture near the focus of expansion
        # stays resolvable instead of aliasing into noise
        tex_g = ndimage.gaussian_filter(tex_g, 1.5)
        tex_w = ndimage.gaussian_filter(tex_w, 1.5)
        poses, _centers = corridor_path(n_frames)
        frames = [np.asarray(render_corridor(host_cam, T, tex_g, tex_w,
                                             px_per_unit=28.0))
                  for T in poses]
        return cam, poses, frames

    tex_near, tex_far = make_textures(rng)
    period = 100
    amp = 1.4
    poses = []
    for i in range(n_frames):
        phase = 2.0 * np.pi * i / period
        x = amp * 0.5 * (1.0 - np.cos(phase))      # 0 -> amp -> 0 sweep
        y = 0.08 * np.sin(2.0 * phase)
        yaw = 0.02 * np.sin(phase)
        tau = np.asarray([-x, -y, 0.0, 0.0, yaw, 0.0], np.float32)
        poses.append(NpSE3.exp(tau))
    frames = [np.asarray(render_scene(host_cam, T, tex_near, tex_far))
              for T in poses]
    return cam, poses, frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--kitti-res", action="store_true",
                    help="render at 1240x376 (slower)")
    ap.add_argument("--profile", choices=("lateral", "forward"),
                    default="lateral",
                    help="motion profile: lateral out-and-back sweeps "
                         "(max parallax) or KITTI-like forward driving "
                         "with turns + a rotation-only stress segment")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="shard window BA over all local devices")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closure (debug/ablation)")
    ap.add_argument("--no-sparse-align", action="store_true",
                    help="disable SVO sparse image alignment (on by "
                         "default here so the evidence run exercises every "
                         "flagship stage)")
    ap.add_argument("--no-fused", action="store_true",
                    help="per-stage dispatches instead of the fused frontend "
                         "(with --sync, attributes a device fault to its "
                         "stage)")
    ap.add_argument("--batch", type=int, default=8,
                    help="frames per device dispatch (the device-resident "
                         "scan loop; 1 = per-frame host driver)")
    ap.add_argument("--uint8", action="store_true",
                    help="ship frames to the device as uint8 (4x less "
                         "upload; quantizes rendered float frames)")
    ap.add_argument("--sync", action="store_true",
                    help="block after every frame (localizes async device "
                         "faults to the frame that queued them)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from dr3_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    if args.kitti_res:
        args.width, args.height = 1240, 376

    from dr3_tpu.pipelines.vo import MonoVO
    from dr3_tpu.utils.config import Config
    from dr3_tpu.viz.ate import ate_rmse

    rng = np.random.default_rng(args.seed)
    print(f"rendering {args.frames} {args.profile} frames at "
          f"{args.width}x{args.height}...")
    cam, poses, frames = make_sequence(args.frames, args.width, args.height,
                                       rng, profile=args.profile)

    # forward profile: ~1/3 of corners sit in the aliased far field near
    # the focus of expansion and die early — the init gate must tolerate it
    min_tracked = 50 if args.profile == "forward" else 60
    cfg = Config(
        fast_threshold=8.0,
        init_min_features=60, init_min_tracked=min_tracked,
        init_min_triangulated=30, init_min_disparity=2.0,
        kf_disparity=12.0,
        max_points=8192,            # modest capacity -> compactions happen
        loop_closure=not args.no_loop, loop_db_capacity=64,
        loop_min_gap_frames=60, loop_min_score=0.6,
        loop_min_inliers=20, loop_cooldown_kfs=4,
        fused_frontend=not args.no_fused,
        use_sparse_align=not args.no_sparse_align,
        frames_per_dispatch=args.batch,
        scan_transfer_uint8=args.uint8,
    )
    mesh = None
    if args.distributed:
        from dr3_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    vo = MonoVO(cam, cfg, mesh=mesh)

    import jax as _jax

    warm = min(40, args.frames // 4)
    batched = args.batch > 1 and not args.sync and not args.no_fused \
        and mesh is None
    t_all0 = time.perf_counter()
    if batched:
        vo.process_batch(frames[:warm])
        t0 = time.perf_counter()
        vo.process_batch(frames[warm:])
    else:
        for i, f in enumerate(frames[:warm]):
            vo.process(f)
            if args.sync:
                _jax.block_until_ready(vo.map.xyz)
                print(f"frame {i} ok (kf={vo.kf_count})", flush=True)
        t0 = time.perf_counter()
        for i, f in enumerate(frames[warm:]):
            vo.process(f)
            if args.sync:
                _jax.block_until_ready(vo.map.xyz)
                print(f"frame {warm + i} ok (kf={vo.kf_count})", flush=True)
    dt = time.perf_counter() - t0
    dt_all = time.perf_counter() - t_all0
    fps = (args.frames - warm) / dt

    gt = np.stack([np.asarray(p.center()) for p in poses])
    est = vo.positions()
    moving = np.nonzero(np.linalg.norm(est, axis=1) > 1e-9)[0]
    i0 = max(int(moving[0]) - 1, 0) if moving.size else 0
    a = ate_rmse(est[i0:], gt[i0:], with_scale=True)
    traj_len = float(np.linalg.norm(np.diff(gt[i0:], axis=0), axis=1).sum())

    print(vo.report())
    out = {
        "frames": args.frames,
        "resolution": f"{args.width}x{args.height}",
        "pipeline_frames_per_sec": round(fps, 2),
        "wall_clock_total_s": round(dt_all, 1),
        "ate_rmse": round(float(a.rmse), 4),
        "ate_pct_of_trajectory": round(100.0 * float(a.rmse) / traj_len, 2),
        "trajectory_length": round(traj_len, 2),
        "keyframes": vo.kf_count,
        "map_compactions": vo.n_compactions,
        "loop_closures": vo.n_loop_closures,
        "relocalizations": vo.n_relocalizations,
        "distributed": bool(mesh),
        "frames_per_dispatch": args.batch if batched else 1,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
