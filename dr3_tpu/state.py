"""World state as fixed-capacity struct-of-arrays.

Replaces the reference's pointer-web data model — Frame/Feature/Point/Map
with bidirectional observation lists (reference include/frame.hpp:22-95,
include/features.hpp:27-60, include/point.hpp:13-56, include/map.hpp:13-31)
— with masked flat arrays (SURVEY §7 design stance):

* ``TrackState``: one slot per detection-grid cell; a track is a feature
  observed in the current frame, optionally bound to a map point (the
  Feature role, frame<->point wiring by integer ids instead of pointers);
* ``KeyframeState``: ring of keyframe poses + a *snapshot* of the track
  table at keyframe creation — this snapshot IS the observation table
  (the reference rebuilds exactly this flat layout from its pointer web
  before every BA, src/optimizer.cpp:29-41; here it is primary);
* ``MapState``: landmark positions + liveness (the Map role).

All states are immutable pytrees updated functionally — which also removes
the reference's Map data race with the render thread (SURVEY §5: viewer
iterates Map while the pipeline appends, no mutex).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dr3_tpu.geometry.lie import SE3


class TrackState(NamedTuple):
    px: jnp.ndarray        # [N, 2] current-frame pixel position
    ref_px: jnp.ndarray    # [N, 2] pixel in the originating keyframe
    ref_kf: jnp.ndarray    # [N] keyframe slot where the track started
    point: jnp.ndarray     # [N] map point id, -1 = not yet triangulated
    age: jnp.ndarray       # [N] frames since spawn
    valid: jnp.ndarray     # [N] bool
    ref_patch: jnp.ndarray # [N, A, A] template captured at the last keyframe
                           # (drift-free 'feature_align' anchor)

    @classmethod
    def empty(cls, n: int, patch: int = 9) -> "TrackState":
        return cls(px=jnp.zeros((n, 2), jnp.float32),
                   ref_px=jnp.zeros((n, 2), jnp.float32),
                   ref_kf=jnp.zeros((n,), jnp.int32),
                   point=jnp.full((n,), -1, jnp.int32),
                   age=jnp.zeros((n,), jnp.int32),
                   valid=jnp.zeros((n,), bool),
                   ref_patch=jnp.zeros((n, patch, patch), jnp.float32))

    @property
    def n(self):
        return jnp.sum(self.valid.astype(jnp.int32))


class KeyframeState(NamedTuple):
    wxyz: jnp.ndarray      # [K, 4] T_f_w rotations (world -> frame)
    t: jnp.ndarray         # [K, 3]
    frame_id: jnp.ndarray  # [K] source frame index, -1 = empty slot
    valid: jnp.ndarray     # [K] bool
    obs_px: jnp.ndarray    # [K, N, 2] track pixels at keyframe creation
    obs_point: jnp.ndarray # [K, N] map point id per track slot (-1 none)

    @classmethod
    def empty(cls, k: int, n_tracks: int) -> "KeyframeState":
        return cls(wxyz=jnp.zeros((k, 4), jnp.float32).at[:, 0].set(1.0),
                   t=jnp.zeros((k, 3), jnp.float32),
                   frame_id=jnp.full((k,), -1, jnp.int32),
                   valid=jnp.zeros((k,), bool),
                   obs_px=jnp.zeros((k, n_tracks, 2), jnp.float32),
                   obs_point=jnp.full((k, n_tracks), -1, jnp.int32))

    def poses(self) -> SE3:
        return SE3(self.wxyz, self.t)

    @property
    def n(self):
        return jnp.sum(self.valid.astype(jnp.int32))


class MapState(NamedTuple):
    xyz: jnp.ndarray       # [P, 3] world positions
    valid: jnp.ndarray     # [P] bool

    @classmethod
    def empty(cls, p: int) -> "MapState":
        return cls(xyz=jnp.zeros((p, 3), jnp.float32),
                   valid=jnp.zeros((p,), bool))

    @property
    def n(self):
        return jnp.sum(self.valid.astype(jnp.int32))

    def n_observations(self, kfs: KeyframeState):
        """Total live observations (Map::n_observations, src/map.cpp:21-26)."""
        live = (kfs.obs_point >= 0) & kfs.valid[:, None]
        return jnp.sum(live.astype(jnp.int32))


# ---------------------------------------------------------------------------
# map compaction
# ---------------------------------------------------------------------------

@jax.jit
def compact_map(map_state: MapState, keep: jnp.ndarray):
    """Compress live map points to the front of the capacity array.

    The reference's Map only ever grows (its global BA got "ridiculously
    slow", reference README.md:44-45); with static shapes, growth is a
    hard capacity instead, so long sequences need reclamation. ``keep``
    marks the point ids still referenced anywhere (live tracks, keyframe
    observations, loop database); everything else is dropped and survivors
    are renumbered densely.

    Returns (compacted MapState, new_id [P] with -1 for dropped, n_live).
    Remap every id table through ``remap_point_ids(ids, new_id)``.
    """
    P = keep.shape[0]
    keep = keep & map_state.valid
    new_id = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, -1)
    dest = jnp.where(keep, new_id, P)  # out-of-range -> dropped by scatter
    xyz = jnp.zeros_like(map_state.xyz).at[dest].set(map_state.xyz,
                                                     mode="drop")
    valid = jnp.zeros_like(map_state.valid).at[dest].set(keep, mode="drop")
    return MapState(xyz=xyz, valid=valid), new_id, jnp.sum(
        keep.astype(jnp.int32))


@jax.jit
def remap_point_ids(ids: jnp.ndarray, new_id: jnp.ndarray) -> jnp.ndarray:
    """Rewrite a point-id table (-1 = none) through a compaction mapping."""
    safe = jnp.clip(ids, 0, new_id.shape[0] - 1)
    return jnp.where(ids >= 0, new_id[safe], -1).astype(jnp.int32)
