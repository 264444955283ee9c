"""FAST / Shi-Tomasi / NMS / grid-bucket detection tests."""

import jax.numpy as jnp
import numpy as np

from dr3_tpu.ops import corners, pyramid


def checkerboard(h, w, sq):
    ys, xs = np.mgrid[0:h, 0:w]
    return (((ys // sq) + (xs // sq)) % 2).astype(np.float32)


def test_fast_finds_isolated_dot():
    img = np.zeros((32, 32), np.float32)
    img[16, 16] = 1.0
    score = np.asarray(corners.fast_score_map(jnp.asarray(img), threshold=20.0))
    assert score[16, 16] > 0
    # dot is the unique strongest response
    assert score[16, 16] == score.max()


def test_fast_flat_image_no_corners():
    img = jnp.full((32, 32), 0.5)
    score = np.asarray(corners.fast_score_map(img, threshold=20.0))
    assert (score == 0).all()


def test_fast_edge_is_not_corner():
    # vertical step edge: no 10-contiguous arc is all brighter/darker
    img = np.zeros((32, 32), np.float32)
    img[:, 16:] = 1.0
    score = np.asarray(corners.fast_score_map(jnp.asarray(img), threshold=20.0))
    assert (score[5:-5, 14:18] == 0).all()


def test_fast_rectangle_l_corners():
    # FAST-10 fires on L-junctions (a rectangle's 4 corners), where ~12
    # contiguous circle pixels are darker — but NOT on checkerboard
    # X-junctions (alternating arcs of ~8 < 10).
    img = np.zeros((64, 64), np.float32)
    img[20:44, 16:48] = 1.0
    score = np.asarray(corners.fast_score_map(jnp.asarray(img), threshold=20.0))
    for y, x in [(20, 16), (20, 47), (43, 16), (43, 47)]:
        assert score[y - 2:y + 3, x - 2:x + 3].max() > 0, (y, x)
    xjunc = checkerboard(64, 64, 8)
    xscore = np.asarray(corners.fast_score_map(jnp.asarray(xjunc), threshold=20.0))
    assert (xscore[10:-10, 10:-10] == 0).all()


def test_nms_unique_peak():
    score = np.zeros((16, 16), np.float32)
    score[8, 8] = 10.0
    score[8, 9] = 9.0  # suppressed neighbor
    score[3, 3] = 5.0
    keep = np.asarray(corners.nms3x3(jnp.asarray(score)))
    assert keep[8, 8] and keep[3, 3]
    assert not keep[8, 9]


def test_shi_tomasi_corner_vs_edge():
    img = np.zeros((32, 32), np.float32)
    img[16:, 16:] = 1.0  # L-corner at (16,16)
    st = np.asarray(corners.shi_tomasi_map(jnp.asarray(img)))
    edge_score = st[25, 16]   # on the vertical edge, far from corner
    corner_score = st[16, 16]
    assert corner_score > edge_score
    assert corner_score > 0


def test_shi_tomasi_flat_zero():
    st = np.asarray(corners.shi_tomasi_map(jnp.full((32, 32), 0.3)))
    np.testing.assert_allclose(st, 0.0, atol=1e-5)


def blobs(h, w, seed=0):
    """High-contrast random binary blobs — rich in L-corners."""
    from scipy import ndimage
    r = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(r.uniform(0, 1, (h, w)), 3.0)
    return (img > np.median(img)).astype(np.float32)


def test_detect_features_grid_capacity():
    img = jnp.asarray(blobs(90, 120))
    pyr = pyramid.build_pyramid(img, 3)
    feats = corners.detect_features(pyr, cell_size=30, detection_threshold=20.0)
    # grid is ceil(120/30) x ceil(90/30) = 4 x 3
    assert feats.xy.shape == (12, 2)
    assert int(feats.n) > 0
    # every valid corner lies in its own cell
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    cells = set()
    for x, y in xy:
        c = (int(y) // 30, int(x) // 30)
        assert c not in cells
        cells.add(c)


def test_detect_features_occupancy_blocks():
    img = jnp.asarray(blobs(90, 120))
    pyr = pyramid.build_pyramid(img, 3)
    all_occ = jnp.ones((12,), bool)
    feats = corners.detect_features(pyr, cell_size=30, occupancy=all_occ)
    assert int(feats.n) == 0


def test_detect_on_kitti_over_100(kitti_pair):
    """Reference init requires >=100 corners on KITTI frame 0
    (src/initialization.cpp:556)."""
    img = jnp.asarray(kitti_pair[0])
    pyr = pyramid.build_pyramid(img, 3)
    feats = corners.detect_features(pyr, cell_size=30, detection_threshold=20.0,
                                    fast_threshold=20.0)
    assert int(feats.n) >= 100


def test_make_occupancy():
    xy = jnp.asarray([[5.0, 5.0], [35.0, 5.0], [100.0, 80.0]])
    valid = jnp.asarray([True, True, False])
    occ = np.asarray(corners.make_occupancy(xy, valid, (90, 120), 30))
    assert occ.shape == (12,)
    assert occ[0] and occ[1]       # first two cells of row 0
    assert occ.sum() == 2          # invalid feature does not flag


def test_spawn_placement_matches_loop_oracle(rng):
    """The scatter-free argsort placement in _spawn_tracks must equal the
    obvious sequential rule: the r-th detected corner (in raster order of
    valid detections) fills the r-th free track slot (in index order).
    Pinned against a python-loop oracle so future rewrites cannot silently
    change placement semantics (the formulation is scatter-free)."""
    import jax.numpy as jnp

    from dr3_tpu.pipelines.vo import _spawn_tracks
    from dr3_tpu.state import TrackState
    from dr3_tpu.utils.config import Config

    cfg = Config(cell_size=30, fast_threshold=8.0, min_corner_score=5.0)
    h, w = 120, 180
    # textured random scene (noise breaks the NMS plateau ties a clean
    # geometric pattern would produce)
    from scipy import ndimage

    base = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 2.0)
    img = (0.7 * (base > np.median(base)) + 0.3 *
           rng.uniform(0, 1, (h, w))).astype(np.float32)
    pyr = [jnp.asarray(img)]

    n_cols = -(-w // cfg.cell_size)
    n_rows = -(-h // cfg.cell_size)
    n = n_cols * n_rows
    tracks = TrackState.empty(n, cfg.feature_align_patch)
    # occupy an arbitrary subset of slots with live tracks placed in their
    # own cells (so occupancy blocks those cells)
    occupied = rng.permutation(n)[: n // 3]
    px = np.zeros((n, 2), np.float32)
    valid = np.zeros(n, bool)
    for s in occupied:
        r, c = divmod(int(s), n_cols)
        px[s] = [c * cfg.cell_size + 5.0, r * cfg.cell_size + 5.0]
        valid[s] = True
    tracks = tracks._replace(px=jnp.asarray(px), valid=jnp.asarray(valid))

    tr, n_sp = _spawn_tracks(pyr, tracks, cfg, jnp.asarray(3, jnp.int32),
                             (h, w))

    # oracle: recompute detection identically, then place sequentially
    from dr3_tpu.ops.corners import detect_features, make_occupancy

    occ = make_occupancy(jnp.asarray(px), jnp.asarray(valid), (h, w),
                         cfg.cell_size)
    feats = detect_features(pyr, cfg.cell_size, cfg.min_corner_score,
                            cfg.fast_threshold, occupancy=occ)
    fxy = np.asarray(feats.xy)
    fvalid = np.asarray(feats.valid)
    free_slots = [i for i in range(n) if not valid[i]]
    want_px = px.copy()
    want_valid = valid.copy()
    placed = 0
    for i in range(n):
        if fvalid[i] and placed < len(free_slots):
            s = free_slots[placed]
            want_px[s] = fxy[i]
            want_valid[s] = True
            placed += 1
    assert int(n_sp) == placed and placed > 3
    np.testing.assert_array_equal(np.asarray(tr.valid), want_valid)
    np.testing.assert_allclose(np.asarray(tr.px), want_px, atol=1e-5)
    # spawned slots carry the keyframe slot and no map point
    new_mask = want_valid & ~valid
    assert np.all(np.asarray(tr.ref_kf)[new_mask] == 3)
    assert np.all(np.asarray(tr.point)[new_mask] == -1)
