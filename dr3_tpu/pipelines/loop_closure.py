"""Loop closure: place recognition, geometric verification, pose-graph
correction.

The reference has no loop closure at all — its backlog asks for exactly the
backend half ("Add only KeyFrames for graph optimization", "Reduce the
number of points for graph optimization", reference README.md:47-48), and
its front half (place recognition) has no analogue. This module supplies
both, as batched device programs:

* **Place recognition**: every keyframe contributes a global descriptor —
  a zero-mean/unit-norm low-resolution thumbnail of the coarsest pyramid
  level. Querying the database is then one ``[C, D] @ [D]`` matvec (ZNCC
  against every past keyframe at once), masked by temporal separation.
  No bag-of-words tree: brute-force correlation over a few hundred
  keyframes is one small matvec and has no host-side data structure to
  maintain.
* **Geometric verification**: ZNCC patch-descriptor matching
  (ops/match.py) between the query keyframe's corners and the candidate's
  stored corners, then PnP — motion-only Gauss-Newton (ba/schur_lm.py
  ``pose_only_adjust``) of the current pose against the candidate's stored
  3D points, initialized at the *candidate's* pose (place recognition
  firing means the camera is physically near the old viewpoint, so the
  candidate pose is a good basin even when odometry has drifted). Accepted
  on a reprojection-inlier count.
* **Correction**: a keyframe pose graph over the whole database —
  sequential odometry edges between consecutive keyframes plus every
  accepted loop edge — solved by the damped GN of ba/posegraph.py; map
  points and the live window are remapped rigidly by the newest keyframe's
  correction and the next local BA re-settles them.

All state is fixed-capacity struct-of-arrays (append-only keyframe
database); every step jits with static shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dr3_tpu.ba.posegraph import make_graph, optimize_pose_graph
from dr3_tpu.ba.problem import make_problem
from dr3_tpu.ba.schur_lm import pose_only_adjust
from dr3_tpu.geometry.lie import SE3
from dr3_tpu.models.camera import Pinhole
from dr3_tpu.ops.match import match_descriptors, patch_descriptors
from dr3_tpu.state import MapState, TrackState
from dr3_tpu.utils.config import Config


class LoopDatabase(NamedTuple):
    """Append-only keyframe database (capacity C, N corner slots each)."""
    thumb: jnp.ndarray     # [C, D] global descriptors (unit-norm)
    kp_desc: jnp.ndarray   # [C, N, Dp] corner patch descriptors
    kp_px: jnp.ndarray     # [C, N, 2] corner pixels
    kp_xyz: jnp.ndarray    # [C, N, 3] landmark snapshot (world, at insert)
    kp_point: jnp.ndarray  # [C, N] map point id (-1 = none) — makes the
                           # database double as the global-BA observation
                           # table (the reference's BAL layout,
                           # src/optimizer.cpp:29-41)
    kp_has: jnp.ndarray    # [C, N] corner has a live landmark
    wxyz: jnp.ndarray      # [C, 4] keyframe pose world->frame
    t: jnp.ndarray         # [C, 3]
    frame_id: jnp.ndarray  # [C] source frame index (-1 = empty)
    valid: jnp.ndarray     # [C]

    @classmethod
    def empty(cls, c: int, n: int, thumb_dim: int, desc_dim: int) -> "LoopDatabase":
        return cls(
            thumb=jnp.zeros((c, thumb_dim), jnp.float32),
            kp_desc=jnp.zeros((c, n, desc_dim), jnp.float32),
            kp_px=jnp.zeros((c, n, 2), jnp.float32),
            kp_xyz=jnp.zeros((c, n, 3), jnp.float32),
            kp_point=jnp.full((c, n), -1, jnp.int32),
            kp_has=jnp.zeros((c, n), bool),
            wxyz=jnp.zeros((c, 4), jnp.float32).at[:, 0].set(1.0),
            t=jnp.zeros((c, 3), jnp.float32),
            frame_id=jnp.full((c,), -1, jnp.int32),
            valid=jnp.zeros((c,), bool))

    @property
    def n(self):
        return jnp.sum(self.valid.astype(jnp.int32))


class LoopEntry(NamedTuple):
    thumb: jnp.ndarray
    kp_desc: jnp.ndarray
    kp_px: jnp.ndarray
    kp_xyz: jnp.ndarray
    kp_point: jnp.ndarray
    kp_has: jnp.ndarray


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def thumbnail_descriptor(img: jnp.ndarray, th: int, tw: int) -> jnp.ndarray:
    """[th*tw] zero-mean unit-norm thumbnail of a (coarse pyramid) image."""
    small = jax.image.resize(img, (th, tw), method="linear")
    d = small.reshape(-1)
    d = d - d.mean()
    return d / jnp.maximum(jnp.linalg.norm(d), 1e-6)


def query_thumbnails(pyr_coarse: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """[R, D] place-recognition QUERY descriptors: the axis-aligned
    thumbnail plus the coarse image rotated by +-k*step degrees about its
    center. Database entries store only the axis-aligned thumbnail; max-
    over-rotations at query time makes recognition tolerate in-plane
    camera roll at revisit (the regime where the reference's ORB is
    invariant and a single ZNCC thumbnail is not, round-4 verdict)."""
    from dr3_tpu.ops.warp import bilinear_sample

    thumbs = [thumbnail_descriptor(pyr_coarse, cfg.loop_thumb_h,
                                   cfg.loop_thumb_w)]
    R = max(int(cfg.loop_query_rotations), 1)
    H, W = pyr_coarse.shape
    if R > 1:
        ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                              jnp.arange(W, dtype=jnp.float32), indexing="ij")
        cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        x0, y0 = xs - cx, ys - cy
        import numpy as _np
        for k in range(1, R // 2 + 1):
            for sign in (1.0, -1.0):
                a = sign * k * float(cfg.loop_query_rot_step_deg) * _np.pi / 180.0
                c, s = float(_np.cos(a)), float(_np.sin(a))
                coords = jnp.stack([c * x0 - s * y0 + cx,
                                    s * x0 + c * y0 + cy], axis=-1)
                rot, _ = bilinear_sample(pyr_coarse, coords[None], clamp=True)
                thumbs.append(thumbnail_descriptor(
                    rot[0], cfg.loop_thumb_h, cfg.loop_thumb_w))
    return jnp.stack(thumbs)


@functools.partial(jax.jit, static_argnums=(4,))
def make_entry(pyr_coarse: jnp.ndarray, img_desc: jnp.ndarray,
               tracks: TrackState, map_state: MapState,
               cfg: Config) -> LoopEntry:
    """Build a database entry from the current keyframe's pyramid + tracks.

    ``img_desc`` must be pyramid level ``cfg.loop_desc_level`` — corner
    coordinates and the sample spread are rescaled to that level here, so
    the descriptor footprint in full-res pixels is unchanged but the
    samples read band-limited content (rotation-tolerant; see the config
    field's rationale)."""
    thumb = thumbnail_descriptor(pyr_coarse, cfg.loop_thumb_h, cfg.loop_thumb_w)
    scale = 1.0 / (2.0 ** cfg.loop_desc_level)
    desc = patch_descriptors(img_desc, tracks.px * scale, tracks.valid,
                             patch=cfg.loop_desc_patch,
                             spread=cfg.loop_desc_spread * scale,
                             oriented=cfg.loop_oriented_desc)
    pt = jnp.maximum(tracks.point, 0)
    has = tracks.valid & (tracks.point >= 0) & map_state.valid[pt]
    xyz = jnp.where(has[:, None], map_state.xyz[pt], 0.0)
    return LoopEntry(thumb=thumb, kp_desc=desc, kp_px=tracks.px,
                     kp_xyz=xyz,
                     kp_point=jnp.where(has, tracks.point, -1),
                     kp_has=has)


@jax.jit
def db_add(db: LoopDatabase, slot, entry: LoopEntry, wxyz, t,
           frame_id) -> LoopDatabase:
    return LoopDatabase(
        thumb=db.thumb.at[slot].set(entry.thumb),
        kp_desc=db.kp_desc.at[slot].set(entry.kp_desc),
        kp_px=db.kp_px.at[slot].set(entry.kp_px),
        kp_xyz=db.kp_xyz.at[slot].set(entry.kp_xyz),
        kp_point=db.kp_point.at[slot].set(entry.kp_point),
        kp_has=db.kp_has.at[slot].set(entry.kp_has),
        wxyz=db.wxyz.at[slot].set(wxyz),
        t=db.t.at[slot].set(t),
        frame_id=db.frame_id.at[slot].set(frame_id),
        valid=db.valid.at[slot].set(True))


@jax.jit
def db_compact(db: LoopDatabase, keep: jnp.ndarray):
    """Compact the database to the ``keep``-marked entries, preserving time
    order (slot order = time order is what optimize_db_graph's sequential
    odometry edges rely on). Returns (new_db, old_to_new [C] int32 with -1
    for evicted slots, n_kept).

    This is the capacity policy for unbounded sequences: when the append
    cursor hits capacity the driver halves temporal density (keep every
    other old keyframe, always keep the newest few) and keeps appending —
    place recognition stays able to close loops against the *whole* past,
    just at coarser sampling, instead of silently ignoring new keyframes.
    """
    C = keep.shape[0]
    keep = keep & db.valid
    idx = jnp.arange(C, dtype=jnp.int32)
    order = jnp.argsort(jnp.where(keep, idx, C + idx))  # kept first, in order
    n_keep = jnp.sum(keep.astype(jnp.int32))
    new_valid = idx < n_keep
    old_to_new = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, -1)

    def g(arr, fill):
        out = arr[order]
        m = new_valid.reshape((C,) + (1,) * (arr.ndim - 1))
        return jnp.where(m, out, jnp.asarray(fill, arr.dtype))

    ident = jnp.zeros((C, 4), db.wxyz.dtype).at[:, 0].set(1.0)
    return LoopDatabase(
        thumb=g(db.thumb, 0.0),
        kp_desc=g(db.kp_desc, 0.0),
        kp_px=g(db.kp_px, 0.0),
        kp_xyz=g(db.kp_xyz, 0.0),
        kp_point=g(db.kp_point, -1),
        kp_has=g(db.kp_has, False),
        wxyz=jnp.where(new_valid[:, None], db.wxyz[order], ident),
        t=g(db.t, 0.0),
        frame_id=g(db.frame_id, -1),
        valid=new_valid,
    ), old_to_new.astype(jnp.int32), n_keep


@functools.partial(jax.jit, static_argnums=(6,))
def insert_and_query(db: LoopDatabase, slot, pyr_coarse, img_desc,
                     tracks: TrackState, map_state: MapState, cfg: Config,
                     wxyz, t, frame_id):
    """Entry build + database append + place-recognition query as ONE
    device program (separately they are 3 dispatches + a fetch per
    keyframe).
    ``img_desc`` = pyramid level ``cfg.loop_desc_level`` (see make_entry).
    Returns (new_db, entry, packed [cand_as_float, score]); the temporal
    gap mask makes a self-match impossible, so insert-then-query is safe
    (same argument as the unfused path)."""
    entry = make_entry(pyr_coarse, img_desc, tracks, map_state, cfg)
    db2 = db_add(db, slot, entry, wxyz, t, frame_id)
    q = query_thumbnails(pyr_coarse, cfg)
    cand, score = db_query(db2, q, frame_id,
                           cfg.loop_min_gap_frames, cfg.loop_min_score)
    return db2, entry, jnp.stack([cand.astype(jnp.float32), score])


@jax.jit
def db_query(db: LoopDatabase, thumb: jnp.ndarray, frame_id, min_gap,
             min_score):
    """Best loop candidate: argmax ZNCC over keyframes at least ``min_gap``
    frames in the past. ``thumb`` may be [D] (one query) or [R, D]
    (rotated query set, :func:`query_thumbnails`) — the score is the max
    over queries per database row. Returns (slot or -1, score)."""
    q = jnp.atleast_2d(thumb)                  # [R, D]
    sims = jnp.max(db.thumb @ q.T, axis=1)     # [C] — one matmul, max over R
    ok = db.valid & (frame_id - db.frame_id >= min_gap)
    sims = jnp.where(ok, sims, -jnp.inf)
    best = jnp.argmax(sims)
    score = sims[best]
    hit = score >= min_score
    return jnp.where(hit, best.astype(jnp.int32), -1), score


# ---------------------------------------------------------------------------
# geometric verification (descriptor match + PnP)
# ---------------------------------------------------------------------------

class LoopVerify(NamedTuple):
    ok: jnp.ndarray         # scalar bool
    wxyz: jnp.ndarray       # fitted current pose (world->cur) [4]
    t: jnp.ndarray          # [3]
    n_matches: jnp.ndarray
    n_inliers: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(4,))
def verify_loop(db: LoopDatabase, cand, entry: LoopEntry, cam: Pinhole,
                cfg: Config) -> LoopVerify:
    """Match current corners to the candidate's, PnP the current pose
    against the candidate's landmark snapshot, gate on reprojection
    inliers. The PnP is Huber-robust GN initialized at the candidate pose
    (the physically-near prior), so it is immune to odometry drift."""
    cand = jnp.maximum(cand, 0)
    valid1 = jnp.any(entry.kp_desc != 0.0, axis=-1)
    m = match_descriptors(entry.kp_desc, db.kp_desc[cand], valid1,
                          db.kp_has[cand],
                          min_score=cfg.loop_match_min_score, ratio=0.97)
    w = m.ok.astype(jnp.float32)
    n_matches = jnp.sum(w).astype(jnp.int32)

    intr = jnp.stack([cam.fx, cam.fy, cam.cx, cam.cy])
    T0 = SE3(db.wxyz[cand], db.t[cand])
    points = db.kp_xyz[cand]
    prob = make_problem(
        cams=SE3(T0.wxyz[None], T0.t[None]), points=points, intrinsics=intr,
        obs_cam=jnp.zeros_like(m.idx2), obs_pt=m.idx2, obs_uv=entry.kp_px,
        obs_w=w, cam_fixed=jnp.zeros((1,), bool), dist=cam.dist)
    res = pose_only_adjust(prob, cfg.loop_pnp_iters, cfg.ba_huber_delta)
    T1 = SE3(res.problem.cam_wxyz[0], res.problem.cam_t[0])

    # inlier gate + one clean re-fit on inliers only
    def reproj_err(T: SE3):
        xc = T.apply(points[m.idx2])
        uv = cam.world2cam(xc)
        return jnp.linalg.norm(uv - entry.kp_px, axis=-1), xc[..., 2]

    err, z = reproj_err(T1)
    inl = (w > 0) & (err < cfg.reproj_threshold) & (z > 1e-3)
    prob2 = prob._replace(cam_wxyz=T1.wxyz[None], cam_t=T1.t[None],
                          obs_w=inl.astype(jnp.float32))
    res2 = pose_only_adjust(prob2, 5, cfg.ba_huber_delta)
    T2 = SE3(res2.problem.cam_wxyz[0], res2.problem.cam_t[0])
    err2, z2 = reproj_err(T2)
    inl2 = (w > 0) & (err2 < cfg.reproj_threshold) & (z2 > 1e-3)
    n_inl = jnp.sum(inl2.astype(jnp.int32))
    ok = (n_inl >= cfg.loop_min_inliers) & \
        jnp.all(jnp.isfinite(T2.wxyz)) & jnp.all(jnp.isfinite(T2.t))
    return LoopVerify(ok=ok, wxyz=T2.wxyz, t=T2.t,
                      n_matches=n_matches, n_inliers=n_inl)


# ---------------------------------------------------------------------------
# global bundle adjustment over the database
# ---------------------------------------------------------------------------

def global_ba_problem(db: LoopDatabase, map_state: MapState, intr,
                      dist=None):
    """Flatten the whole keyframe database into one BA problem — every
    keyframe ever made vs the full map (the reference's global_BA input,
    src/optimizer.cpp:6-81, which flattens its Map to exactly this BAL
    layout; here the database already IS that layout). Gauge: the two
    oldest keyframes are fixed (slots are time-ordered, append-only)."""
    C, N = db.kp_point.shape
    obs_cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), N)
    obs_pt_raw = db.kp_point.reshape(-1)
    obs_uv = db.kp_px.reshape(-1, 2)
    pt = jnp.maximum(obs_pt_raw, 0)
    w = ((obs_pt_raw >= 0)
         & jnp.repeat(db.valid, N)
         & map_state.valid[pt]).astype(jnp.float32)
    fixed = (~db.valid) | (jnp.arange(C) < 2)
    return make_problem(cams=SE3(db.wxyz, db.t), points=map_state.xyz,
                        intrinsics=intr, obs_cam=obs_cam, obs_pt=pt,
                        obs_uv=obs_uv, obs_w=w, cam_fixed=fixed, dist=dist)


# ---------------------------------------------------------------------------
# pose-graph correction over the database
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(6,))
def optimize_db_graph(db: LoopDatabase, loop_i, loop_j, loop_wxyz, loop_t,
                      loop_w, pgo_iters: int):
    """Pose graph over all database keyframes: sequential odometry edges
    (slot k -> k+1, database is append-only so slot order = time order)
    plus accepted loop edges. Node 0 fixed (gauge). Returns the corrected
    SE3 poses [C] and (initial, final) costs."""
    C = db.valid.shape[0]
    poses = SE3(db.wxyz, db.t)

    seq_i = jnp.arange(C - 1, dtype=jnp.int32)
    seq_j = seq_i + 1
    seq_ok = db.valid[:-1] & db.valid[1:]
    Ti = poses[seq_i]
    Tj = poses[seq_j]
    seq_rel = Ti @ Tj.inverse()   # measured T_ij from odometry
    seq_w = seq_ok.astype(jnp.float32)

    edge_i = jnp.concatenate([seq_i, loop_i])
    edge_j = jnp.concatenate([seq_j, loop_j])
    rel = SE3(jnp.concatenate([seq_rel.wxyz, loop_wxyz]),
              jnp.concatenate([seq_rel.t, loop_t]))
    w = jnp.concatenate([seq_w, loop_w])

    fixed = (~db.valid) | (jnp.arange(C) == 0)
    g = make_graph(poses, edge_i, edge_j, rel, weights=w, fixed=fixed)
    return optimize_pose_graph(g, pgo_iters)


@jax.jit
def world_correction(T_old: SE3, T_new: SE3) -> SE3:
    """Rigid map G with X_new = G·X_old such that the keyframe whose pose
    changed T_old -> T_new sees identical pixels: G = T_new^-1 · T_old.
    Poses transform as T' = T_old_pose · G^-1."""
    return T_new.inverse() @ T_old


@jax.jit
def apply_correction_points(G: SE3, xyz: jnp.ndarray, valid) -> jnp.ndarray:
    return jnp.where(valid[:, None], G.apply(xyz), xyz)


@jax.jit
def apply_correction_db(db: LoopDatabase, poses_new: SE3) -> LoopDatabase:
    """Move every database entry to its PGO-corrected pose, transporting
    each entry's landmark snapshot by that entry's own rigid correction
    (so stored pose/landmark pairs stay reprojection-consistent)."""
    T_old = SE3(db.wxyz, db.t)
    G = poses_new.inverse() @ T_old                     # [C] world maps
    xyz = SE3(G.wxyz[:, None], G.t[:, None]).apply(db.kp_xyz)
    keep = db.valid
    return db._replace(
        wxyz=jnp.where(keep[:, None], poses_new.wxyz, db.wxyz),
        t=jnp.where(keep[:, None], poses_new.t, db.t),
        kp_xyz=jnp.where(keep[:, None, None], xyz, db.kp_xyz))
