"""Configuration for the dr3_tpu framework.

Re-provides the reference's global Config singleton (reference
include/config.hpp:12-37, src/config.cpp:7-21) as an immutable dataclass:
defaults below mirror src/config.cpp:8-14, extended with the knobs the
batched pipelines need (static capacities, LK/RANSAC iteration counts that
were hardcoded at call sites in the reference).

Unlike the reference's mutable static singleton, configs here are frozen
pytrees of *static* values: pass a Config into pipeline constructors; jitted
functions close over its fields as Python constants so XLA sees static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class Config:
    # --- reference Config parity (src/config.cpp:8-14) ---
    ransac_iters: int = 50          # stitching RANSAC iterations
    ransac_threshold: float = 5.0   # px inlier threshold (stitch/F)
    cell_size: int = 30             # feature-grid bucket size in px
    n_pyr_levels: int = 3           # image pyramid levels
    min_corner_score: float = 20.0  # min Shi-Tomasi score to keep a corner
    reproj_threshold: float = 5.0   # px reprojection gate
    map_scale: float = 1.0          # median-depth rescale target

    # --- two-view init (reference src/initialization.cpp thresholds) ---
    init_ransac_iters: int = 200    # F-matrix RANSAC model count (.cpp:44)
    init_sigma: float = 1.0         # chi-square sigma (.cpp:579)
    init_min_features: int = 100    # min FAST corners in first frame (.cpp:556)
    init_min_tracked: int = 100     # min LK-tracked matches (.cpp:655)
    init_min_triangulated: int = 50 # min accepted 3D points (ref needs
                                    # max(0.9N,50) inside + 100 outside)
    init_min_disparity: float = 1.0 # median px disparity to accept 2nd frame

    # --- LK tracker (reference cv::calcOpticalFlowPyrLK args, .cpp:608-613) ---
    klt_window: int = 15            # half the reference's 30px window => 15
    klt_levels: int = 4
    klt_iters: int = 10             # fixed GN iterations per level
    klt_eps: float = 1e-3

    # --- FAST detector ---
    fast_threshold: float = 10.0    # intensity delta for FAST-10 arc test
                                    # (reference hardcodes 20, features.cpp:59;
                                    # 10 yields denser KITTI coverage)

    # --- feature alignment (SVO 'feature_align' stage) ---
    feature_align: bool = True      # refine tracks vs keyframe templates
    feature_align_patch: int = 9    # template size (odd)
    feature_align_iters: int = 8

    # --- sparse image alignment (SVO 'sparse_img_align' stage) ---
    use_sparse_align: bool = True   # direct coarse-level pose pre-tracking
                                    # (DEFAULT ON since round 4: the shipped
                                    # configuration is the measured one)
    align_level: int = 2
    align_half_patch: int = 2
    align_iters: int = 12

    # --- frame-step fusion ---
    fused_frontend: bool = True      # run the whole general-frame hot path
                                     # (pyramid + sparse-align + LK + pose GN
                                     # + gating + kf stats) as ONE jitted
                                     # program — one host->device dispatch
                                     # per frame instead of four. False
                                     # restores per-stage dispatch with
                                     # per-stage Monitor timers (profiling).
    frames_per_dispatch: int = 16    # MonoVO.process_batch scan width: the
                                     # device-resident frame loop consumes
                                     # up to this many frames (general AND
                                     # keyframe work incl. window BA) per
                                     # host dispatch; the host pays ONE
                                     # dispatch + fetch per batch instead of
                                     # several per frame. 1 = per-frame.
                                     # (Chosen for another platform; not
                                     # yet re-measured on the GPU.)
    scan_speculation_depth: int = 1  # dispatched-but-unfetched scan batches
                                     # kept in flight, each chaining off the
                                     # previous batch's device carry. >1
                                     # only helps where device->host copies
                                     # run async with compute; depth 1 is
                                     # the default until a GPU measurement
                                     # (tools/profile_speculation.py) says
                                     # otherwise. Events discard the chain
                                     # beyond the current batch (counted in
                                     # MonoVO.n_discarded_batches).
    scan_transfer_uint8: bool = False  # ship frames to the device as uint8
                                     # (4x less upload traffic,
                                     # /255 on device). Lossless for 8-bit
                                     # sources (KITTI PNGs); off by default
                                     # so float-rendered synthetic frames
                                     # match the per-frame path bitwise.

    # --- keyframe policy ---
    kf_disparity: float = 40.0       # median px disparity vs originating kf
    kf_min_inliers: int = 15         # below this a keyframe is forced
    kf_inlier_ratio: float = 0.5     # vs tracked count at the last keyframe

    # --- loop closure (beyond reference; backend half = README.md:47-48
    #     "KeyFrames for graph optimization" TODO) ---
    loop_closure: bool = True        # enable place recognition + closure
                                     # (DEFAULT ON since round 4)
    loop_db_capacity: int = 256      # keyframe database size (append-only)
    loop_thumb_h: int = 12           # global-descriptor thumbnail rows
    loop_thumb_w: int = 40           # ... cols (ZNCC over [C, h*w] matmul)
    loop_min_gap_frames: int = 100   # min temporal separation of candidates
    loop_min_score: float = 0.80     # thumbnail ZNCC acceptance gate
    loop_desc_patch: int = 8         # corner patch descriptor side
    loop_desc_spread: float = 3.0    # FULL-RES px between descriptor samples
    loop_desc_level: int = 2         # pyramid level descriptors sample from:
                                     # the level-2 image is band-limited to
                                     # ~4 full-res px, so the 3-px sample
                                     # grid is alias-free — under in-plane
                                     # rotation the resampled values stay on
                                     # the same image content instead of
                                     # hitting unrelated full-res noise
                                     # pixels (level 0 ZNCC only matched
                                     # exactly-axis-aligned revisits)
    loop_oriented_desc: bool = True  # rotate each corner's descriptor grid
                                     # to its intensity-centroid orientation
                                     # (ORB's mechanism, ref frame.cpp:22-33)
                                     # so loop verification survives in-
                                     # plane camera roll at revisit
    loop_query_rotations: int = 5    # place-recognition query thumbnails:
                                     # 1 = axis-aligned only; R>1 also
                                     # queries with the coarse image
                                     # rotated +-(R//2)*step so the global
                                     # descriptor finds rolled revisits
    loop_query_rot_step_deg: float = 6.0
    loop_match_min_score: float = 0.70
    loop_min_inliers: int = 25       # PnP reprojection inliers to accept
    loop_pnp_iters: int = 15
    loop_max_edges: int = 16         # loop-edge capacity in the pose graph
    loop_edge_weight: float = 5.0    # loop edges vs odometry edges in PGO
    loop_cooldown_kfs: int = 5       # keyframes between closures
    loop_pgo_iters: int = 12

    # --- static capacities (compiled shapes) ---
    max_corners: int = 2048         # per-frame track capacity cap (grid
                                    # cells above this are truncated)
    max_points: int = 16384         # map landmark capacity
    max_keyframes: int = 32         # sliding-window keyframe capacity

    # --- bundle adjustment ---
    ba_max_iters: int = 8           # LM iterations per window BA
    ba_lambda0: float = 1e-3
    ba_huber_delta: float = 5.0     # px, robust loss scale
    ba_jacobi_scaling: bool = True  # fixes reference's Cholesky failures
    ba_solver: str = "pcg"          # window-BA Schur solve: "pcg" (matrix-
                                    # free + SCHUR_JACOBI, loose Q-stagnation
                                    # forcing — the in-loop default: each
                                    # keyframe re-optimizes an overlapping
                                    # window, so LM absorbs step
                                    # inexactness; not yet re-measured on
                                    # the GPU)
                                    # | "explicit" | "zexplicit" | "auto"
    ba_cg_iters: int = 64           # CG iteration cap (pcg only)
    ba_cg_tol: float = 1e-2         # CG residual tolerance (pcg only)
    ba_q_eta: float = 0.1           # Ceres-style Q-stagnation forcing; 0
                                    # disables (near-exact steps)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_cli(cls, argv: list[str]) -> "Config":
        """Parse ``--key=value`` overrides (the reference links gflags but
        never parses flags, tests/slam/test_slam.cc:52-53 — we actually do)."""
        out: dict[str, Any] = {}
        defaults = cls()
        for arg in argv:
            if not arg.startswith("--"):
                continue
            key, _, val = arg[2:].partition("=")
            key = key.replace("-", "_")
            if not hasattr(defaults, key):
                raise ValueError(f"unknown flag --{key}")
            cur = getattr(defaults, key)
            if isinstance(cur, bool):
                out[key] = val.lower() in ("1", "true", "yes", "")
            elif isinstance(cur, int):
                out[key] = int(val)
            elif isinstance(cur, float):
                out[key] = float(val)
            else:
                out[key] = val
        return defaults.replace(**out)
