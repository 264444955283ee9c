#!/usr/bin/env python3
"""Smoke run of dr3_tpu on an NVIDIA GPU: the main path at full width,
through the entry points a user calls, checked against the CPU backend.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # distributed BA + mesh VO, 4 cards

One card runs four phases, each at the sizes the benchmark uses:

1. ops: pyramidal LK, template align, sparse align, the corner response
   and the spherical / perspective warps on a seeded KITTI-size frame pair
   (1240x376, 546 tracks, 4 levels, 10 iterations), GPU against CPU;
2. VO: ``MonoVO.process_batch`` over 64 rendered KITTI-size frames that go
   out and come back, with every stage on; ATE against the rendered ground
   truth, and the batched trajectory against per-frame ``process`` on the
   same card;
3. BA: window BA (32 keyframes x 16,384 points x 17,472 observations) and
   BAL-scale Snavely BA (120 cameras x 60,000 points x 480,000
   observations), each against the same call on the CPU;
4. panorama: ``Panorama.process`` over 8 overlapping 640x480 RGB views with
   spherical pre-warp, canvas against the CPU's.

``--four-cards`` runs only the multi-card path and what it is compared
with: ``dist_bundle_adjust`` over a 4-device mesh against single-card
``bundle_adjust``, and ``MonoVO(mesh=...)`` against ``MonoVO()``.

All inputs come from ``--seed``. Without a GPU the script exits non-zero
and prints no result. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase. ``FULL`` is what the script runs; the
    tests run the same phases at a tiny size on the CPU."""

    width: int = 1240               # KITTI grayscale frame
    height: int = 376
    fx: float = 718.856             # KITTI intrinsics (Pinhole.kitti)
    cx: float = 607.1928
    cy: float = 185.2157
    vo_frames: int = 64
    # Config fields the rendered fixture needs: the sequence is 64 frames,
    # so the 100-frame loop-candidate gap (tuned for 10 Hz capture) would
    # leave the return leg no candidates
    vo_overrides: tuple = (("loop_min_gap_frames", 24),)
    window: tuple = (32, 16384, 546)   # keyframes, points, tracks/keyframe
    window_iters: int = 10
    bal: tuple = (120, 60000, 4000)    # cameras, points, observations/camera
    bal_iters: int = 10
    bal_cpu_iters: int = 3            # the CPU side compares this iterate
    pano_views: int = 8
    pano_width: int = 640
    pano_height: int = 480
    pano_f: float = 600.0


FULL = Sizes()


def check(cond: bool, what: str) -> None:
    """Fail the run (a raise survives ``python -O``, an assert does not)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def _host_cam(sz: Sizes):
    """Plain-float camera for the host-side renderer."""
    return SimpleNamespace(width=sz.width, height=sz.height, fx=sz.fx,
                           fy=sz.fx, cx=sz.cx, cy=sz.cy)


def _run_on(dev, fn, *args):
    """jit ``fn`` on device ``dev`` and bring the result to the host."""
    import jax

    out = jax.jit(fn)(*jax.device_put(args, dev))
    return jax.tree.map(np.asarray, out)


def _scene_points(cam, px):
    """World points of pixels ``px`` [N, 2] seen from the identity pose in
    the two-plane scene of ``render_scene`` (its default plane layout)."""
    d = np.stack([(px[:, 0] - cam.cx) / cam.fx, (px[:, 1] - cam.cy) / cam.fy,
                  np.ones(len(px))], -1)
    near = (np.abs(6.0 * d[:, 0]) < 2.2) & (np.abs(6.0 * d[:, 1]) < 1.6)
    return (d * np.where(near, 6.0, 14.0)[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# phase 1: ops at real widths, GPU against CPU
# ---------------------------------------------------------------------------

def phase_ops(dev, cpu, sz: Sizes, rng) -> dict:
    import jax.numpy as jnp

    from dr3_tpu.geometry.lie import SE3
    from dr3_tpu.io.synth import NpSE3, panorama_views, render_sequence
    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.ops import corners, lk, pyramid, warp
    from dr3_tpu.ops.sparse_align import sparse_align
    from dr3_tpu.utils.config import Config

    cfg = Config()
    hc = _host_cam(sz)
    cam = Pinhole.create(sz.width, sz.height, hc.fx, hc.fy, hc.cx, hc.cy)
    poses = [NpSE3.exp(np.zeros(6)),
             NpSE3.exp([-0.08, 0.0, -0.04, 0.0, 0.004, 0.0])]
    f0, f1 = render_sequence(hc, poses, rng)
    levels = cfg.klt_levels
    out = {}

    # detection on frame 0 gives the track table both backends start from
    def detect(img):
        pyr = pyramid.build_pyramid(img, cfg.n_pyr_levels)
        return corners.detect_features(pyr, cfg.cell_size,
                                       cfg.min_corner_score,
                                       cfg.fast_threshold)
    feats = _run_on(cpu, detect, f0)
    pts = feats.xy.astype(np.float32)
    valid = feats.valid
    log(f"  {len(pts)} tracks ({int(valid.sum())} detected), "
        f"{sz.width}x{sz.height}, {levels} levels, {cfg.klt_iters} iters")

    # corner response: FAST and 3x3 NMS are min/max chains over exactly
    # representable differences, so the corner set must match bit for bit;
    # the Shi-Tomasi value 0.5*(tr - sqrt(tr^2 - 4 det)) cancels, so it
    # gets the loose tolerance of ulp-level reassociation (rtol 2e-3,
    # atol 0.05 in 0-255 units)
    def response(img):
        return (corners.nms3x3(corners.fast_score_map(img,
                                                      cfg.fast_threshold)),
                corners.corner_response(img, cfg.fast_threshold))
    (m_g, r_g), (m_c, r_c) = (_run_on(d, response, f0) for d in (dev, cpu))
    check(np.array_equal(m_g, m_c), "corner NMS mask GPU == CPU")
    err = np.abs(r_g - r_c) - (0.05 + 2e-3 * np.abs(r_c))
    check(err.max() <= 0, "corner_response within rtol 2e-3, atol 0.05")
    out["corners"] = int(m_g.sum())
    log(f"  corner_response: {int(m_g.sum())} NMS corners identical, "
        f"max |d| {np.abs(r_g - r_c).max():.3g}")

    # pyramidal LK. f32 sums in another order move a converging track by
    # ~1e-4 px; the GN freeze at eps=1e-3 px can stop one iteration apart,
    # so tracks ok on both agree to 0.01 px (the 99th percentile, as a
    # handful of tracks on flat texture sit on a near-singular 2x2 system),
    # and the ok-mask, a threshold test on err and conditioning, agrees on
    # 99% of the tracks
    def track(a, b, p, v):
        pa = pyramid.build_pyramid(a, levels)
        pb = pyramid.build_pyramid(b, levels)
        return lk.track_pyramid(pa, pb, p, v,
                                half_window=cfg.klt_window // 2,
                                iters=cfg.klt_iters, eps=cfg.klt_eps)
    lk_g, lk_c = (_run_on(d, track, f0, f1, pts, valid) for d in (dev, cpu))
    _compare_tracks("LK", lk_g, lk_c, out)

    # template align (SVO feature_align) from the CPU's LK positions
    half = cfg.feature_align_patch // 2

    def align(a, b, p_ref, p_cur, v):
        templates = lk.extract_patches(a, p_ref, half)
        return lk.align_to_templates(b, templates, p_cur, v,
                                     iters=cfg.feature_align_iters)
    al_g, al_c = (_run_on(d, align, f0, f1, pts, lk_c.pos, lk_c.ok)
                  for d in (dev, cpu))
    _compare_tracks("template align", al_g, al_c, out)

    # sparse image alignment at level 2: the LM accept test compares f32
    # costs, so the two poses may take different near-tie steps; both must
    # land within 1e-3 (translation, scene units; rotation, rad) of each
    # other
    pts_w = _scene_points(hc, pts)

    def salign(a, b, pw, v):
        lvl = cfg.align_level
        pa = pyramid.build_pyramid(a, lvl + 1)
        pb = pyramid.build_pyramid(b, lvl + 1)
        T0 = SE3.identity()
        res = sparse_align(pa[lvl], pb[lvl], T0, T0, cam, pw, v, level=lvl,
                           half_patch=cfg.align_half_patch,
                           iters=cfg.align_iters)
        return res.T.wxyz, res.T.t, res.cost0, res.cost
    sa_g, sa_c = (_run_on(d, salign, f0, f1, pts_w, valid)
                  for d in (dev, cpu))
    dt = float(np.abs(sa_g[1] - sa_c[1]).max())
    dq = float(np.abs(np.abs(np.dot(sa_g[0], sa_c[0])) - 1.0))
    check(sa_g[3] < sa_g[2], "sparse align lowers the photometric cost")
    check(dt < 1e-3 and np.sqrt(8 * dq) < 1e-3, "sparse-align pose GPU~CPU")
    out["sparse_align_dt"] = dt
    log(f"  sparse align: cost {float(sa_g[2]):.4g} -> {float(sa_g[3]):.4g},"
        f" t {np.round(sa_g[1], 4)} (true {poses[1].t.round(4)}), "
        f"|dt| GPU-CPU {dt:.2e}")

    # warps on a 640x480 RGB view: the source coordinate passes through
    # sin/cos/division, whose last bits differ between backends, so values
    # on pixels valid on both agree to 1e-3 (a 1e-4 px shift times the
    # largest texture gradient), and validity, a threshold on the same
    # coordinate, may flip on at most 0.01% of the pixels (the border)
    view = panorama_views(rng, 1, sz.pano_width, sz.pano_height, sz.pano_f)[0]
    Hm = np.asarray([[1.02, 0.03, 14.0], [-0.02, 0.98, -9.5],
                     [2e-5, -1e-5, 1.0]], np.float32)
    hw = (sz.pano_height, sz.pano_width)
    for name, fn in (
            ("spherical", lambda im: (warp.warp_spherical(im, sz.pano_f),
                                      jnp.ones(im.shape[:2], bool))),
            ("perspective", lambda im: warp.warp_perspective(im, Hm, hw))):
        (w_g, v_g), (w_c, v_c) = (_run_on(d, fn, view) for d in (dev, cpu))
        both = v_g & v_c
        flips = int((v_g != v_c).sum())
        d = float(np.abs(w_g - w_c)[both].max())
        check(d < 1e-3, f"{name} warp values GPU~CPU")
        check(flips <= 1e-4 * v_g.size, f"{name} warp validity GPU~CPU")
        out[f"warp_{name}_max_abs"] = d
        log(f"  warp {name}: max |d| {d:.2e}, validity flips {flips}")
    return out


def _compare_tracks(name, g, c, out):
    ok_g, ok_c = np.asarray(g.ok), np.asarray(c.ok)
    agree = float((ok_g == ok_c).mean())
    both = ok_g & ok_c
    d = np.abs(g.pos - c.pos).max(-1)[both]
    p99 = float(np.percentile(d, 99)) if d.size else 0.0
    check(both.sum() >= 0.5 * max(ok_c.sum(), 1),
          f"{name}: most tracks ok on both")
    check(agree >= 0.99, f"{name}: ok-mask agrees on 99% of tracks")
    check(p99 < 1e-2, f"{name}: positions agree to 0.01 px (99th pct)")
    out[f"{name}_ok"] = int(both.sum())
    log(f"  {name}: ok {int(ok_g.sum())}/{int(ok_c.sum())} (GPU/CPU), "
        f"mask agreement {agree:.4f}, |d| p99 {p99:.2e} max "
        f"{(d.max() if d.size else 0.0):.2e} px")


# ---------------------------------------------------------------------------
# phase 2: VO through MonoVO.process_batch
# ---------------------------------------------------------------------------

def vo_inputs(sz: Sizes, rng):
    """(Pinhole, Config, frames, ground-truth centers) of the VO phase."""
    from dr3_tpu.io.synth import out_and_back_poses, render_sequence
    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.utils.config import Config

    hc = _host_cam(sz)
    cam = Pinhole.create(sz.width, sz.height, hc.fx, hc.fy, hc.cx, hc.cy)
    poses = out_and_back_poses(sz.vo_frames)
    frames = render_sequence(hc, poses, rng)
    gt = np.stack([p.center() for p in poses])
    return cam, Config(**dict(sz.vo_overrides)), frames, gt


def phase_vo(dev, sz: Sizes, rng) -> dict:
    import jax

    from dr3_tpu.pipelines import vo as vo_mod
    from dr3_tpu.viz.ate import ate_rmse

    cam, cfg, frames, gt = vo_inputs(sz, rng)
    log(f"  {len(frames)} frames {sz.width}x{sz.height}, Config overrides "
        f"{dict(sz.vo_overrides)}")
    with jax.default_device(dev):
        vo = vo_mod.MonoVO(cam, cfg)
        t0 = time.perf_counter()
        vo.process_batch(frames)
        dt = time.perf_counter() - t0
        log(vo.report())
        args, kw = vo.scan_args(frames[:cfg.frames_per_dispatch])
        mem = vo_mod._scan_frames.lower(*args, **kw).compile() \
            .memory_analysis()
        log(f"  scan program memory_analysis: {mem}")

        n_kf = sum(1 for s in vo.stats if s.is_keyframe)
        log(f"  keyframes {n_kf}, in-scan window BAs {vo.n_scan_window_bas},"
            f" loop closures {vo.n_loop_closures}, relocalizations "
            f"{vo.n_relocalizations}, wall {dt:.1f} s incl. compile")
        check(vo.stage is vo_mod.Stage.GENERAL, "VO reaches GENERAL")
        check(n_kf >= 3, "at least 3 keyframes")
        check(vo.n_scan_window_bas >= 1, "at least 1 in-scan window BA")
        est = vo.positions()
        check(bool(np.isfinite(est).all()), "finite poses")

        moving = np.nonzero(np.linalg.norm(est, axis=1) > 1e-9)[0]
        check(moving.size > 0, "VO estimates motion")
        i0 = max(int(moving[0]) - 1, 0)
        a = ate_rmse(est[i0:], gt[i0:], with_scale=True)
        length = float(np.linalg.norm(np.diff(gt[i0:], axis=0), axis=1).sum())
        log(f"  Sim(3) ATE {a.rmse:.4f} over a {length:.3f} path "
            f"({100 * a.rmse / length:.2f}%)")
        check(a.rmse < 0.05 * length, "ATE below 5% of trajectory length")

        # the batched scan against the per-frame driver on the same card
        vo_pf = vo_mod.MonoVO(cam, cfg)
        for f in frames:
            vo_pf.process(f)
        d = float(np.abs(vo_pf.positions() - est).max())
        log(f"  batched vs per-frame: keyframes {vo.kf_count}/"
            f"{vo_pf.kf_count}, max |d| {d:.2e}")
        check(vo.kf_count == vo_pf.kf_count, "same keyframe count")
        check(d < 5e-3, "batched == per-frame trajectory (atol 5e-3)")
    return {"keyframes": n_kf, "scan_window_bas": vo.n_scan_window_bas,
            "loop_closures": vo.n_loop_closures,
            "ate_pct": 100 * a.rmse / length, "process_batch_s": dt}


# ---------------------------------------------------------------------------
# phase 3: BA, GPU against CPU
# ---------------------------------------------------------------------------

def _costs(res):
    return float(res.initial_cost), float(res.final_cost)


def phase_ba(dev, cpu, sz: Sizes, rng) -> dict:
    import jax

    from dr3_tpu.ba.schur_lm import bundle_adjust
    from dr3_tpu.ba.snavely import bundle_adjust_snavely
    from dr3_tpu.io.synth import bal_problem, window_ba_problem

    out = {}
    # window BA, auto solver. Both backends run the same exact LM; f32
    # sums in another order shift each iterate's cost in the 6th digit,
    # so after the same iteration count the final costs agree to 1e-3
    # relative
    prob = window_ba_problem(rng, *sz.window)
    it = sz.window_iters
    log(f"  window BA: {prob.n_cams} keyframes x {prob.n_points} points x "
        f"{prob.n_obs} observations, {it} LM iterations")
    mem = bundle_adjust.lower(jax.device_put(prob, dev), it).compile() \
        .memory_analysis()
    log(f"  window BA memory_analysis: {mem}")
    c_g = _costs(bundle_adjust(jax.device_put(prob, dev), it))
    c_c = _costs(bundle_adjust(jax.device_put(prob, cpu), it))
    rel = abs(c_g[1] - c_c[1]) / c_c[1]
    log(f"  window BA cost {c_g[0]:.6g} -> {c_g[1]:.6g} (CPU {c_c[1]:.6g},"
        f" rel {rel:.2e})")
    check(np.isfinite(c_g[1]) and c_g[1] < c_g[0], "window BA lowers cost")
    check(rel < 1e-3, "window BA final cost GPU~CPU (rel 1e-3)")
    out["window_rel"] = rel

    # BAL-scale Snavely BA, auto solver (square-root dense Schur). The CPU
    # side runs the first bal_cpu_iters iterations and is compared with
    # the same iterate on the GPU
    prob = bal_problem(rng, *sz.bal)
    log(f"  BAL BA: {prob.n_cams} cameras x {prob.n_points} points x "
        f"{prob.n_obs} observations, {sz.bal_iters} LM iterations")
    p_g = jax.device_put(prob, dev)
    mem = bundle_adjust_snavely.lower(p_g, sz.bal_iters).compile() \
        .memory_analysis()
    log(f"  BAL BA memory_analysis: {mem}")
    c_full = _costs(bundle_adjust_snavely(p_g, sz.bal_iters))
    c_g = _costs(bundle_adjust_snavely(p_g, sz.bal_cpu_iters))
    c_c = _costs(bundle_adjust_snavely(jax.device_put(prob, cpu),
                                       sz.bal_cpu_iters))
    rel = abs(c_g[1] - c_c[1]) / c_c[1]
    log(f"  BAL BA cost {c_full[0]:.6g} -> {c_full[1]:.6g}; after "
        f"{sz.bal_cpu_iters} iterations GPU {c_g[1]:.6g} CPU {c_c[1]:.6g} "
        f"(rel {rel:.2e})")
    check(np.isfinite(c_full[1]) and c_full[1] < c_full[0],
          "BAL BA lowers cost")
    check(rel < 1e-3, "BAL BA cost GPU~CPU at the same iterate (rel 1e-3)")
    out["bal_rel"] = rel
    return out


# ---------------------------------------------------------------------------
# phase 4: panorama
# ---------------------------------------------------------------------------

def phase_panorama(dev, cpu, sz: Sizes, rng) -> dict:
    import jax

    from dr3_tpu.io.synth import panorama_views
    from dr3_tpu.pipelines.panorama import Panorama, PanType

    views = panorama_views(rng, sz.pano_views, sz.pano_width,
                           sz.pano_height, sz.pano_f)

    def run(d):
        pan = Panorama(focal_length=sz.pano_f, pan_type=PanType.TRANSLATE,
                       feathering_width=40, transfer_uint8=False)
        with jax.default_device(d):
            t0 = time.perf_counter()
            canvas = pan.process(views)
            return canvas, pan.homographies_, time.perf_counter() - t0
    c_g, H_g, dt = run(dev)
    c_c, H_c, _ = run(cpu)
    log(f"  {len(views)} views {sz.pano_width}x{sz.pano_height} -> canvas "
        f"{c_g.shape}, {dt:.1f} s incl. compile")
    check(bool(np.isfinite(c_g).all()), "finite canvas")
    # RANSAC draws the same keys on both backends and the translate-only
    # refit averages inliers, so pair offsets agree to 0.05 px; the canvas
    # then differs by resampling at those offsets: mean |d| 2e-3 and 99th
    # percentile 2e-2 of the [0, 1] range (feather seams carry the tail)
    dH = max(float(np.abs(a[:2, 2] - b[:2, 2]).max())
             for a, b in zip(H_g, H_c))
    check(dH < 0.05, "pair translations GPU~CPU (0.05 px)")
    check(c_g.shape == c_c.shape, "same canvas shape")
    d = np.abs(c_g - c_c)
    log(f"  canvas GPU vs CPU: chained offsets |d| {dH:.2e} px, mean |d| "
        f"{d.mean():.2e}, p99 {np.percentile(d, 99):.2e}")
    check(d.mean() < 2e-3 and np.percentile(d, 99) < 2e-2,
          "canvas GPU~CPU")
    return {"canvas": list(c_g.shape), "panorama_s": dt}


# ---------------------------------------------------------------------------
# four cards: distributed BA and the mesh-attached VO driver
# ---------------------------------------------------------------------------

def phase_four_cards(sz: Sizes, rng, n_devices: int = 4) -> dict:
    from dr3_tpu.ba.schur_lm import bundle_adjust
    from dr3_tpu.io.synth import window_ba_problem
    from dr3_tpu.parallel.dist_ba import dist_bundle_adjust
    from dr3_tpu.parallel.mesh import make_mesh
    from dr3_tpu.pipelines.vo import MonoVO

    mesh = make_mesh(n_devices)
    prob = window_ba_problem(rng, *sz.window)
    it = sz.window_iters
    c_d = _costs(dist_bundle_adjust(prob, max_iters=it, mesh=mesh))
    c_1 = _costs(bundle_adjust(prob, it))
    rel0 = abs(c_d[0] - c_1[0]) / c_1[0]
    rel = abs(c_d[1] - c_1[1]) / c_1[1]
    # the same objective, so the initial costs agree to f32 summation
    # order (1e-4); the distributed LM damps the reduced system without
    # bundle_adjust's Jacobi scaling, so its iterates differ and the final
    # costs are held to 5%, the bound of tests/test_dist_ba.py
    log(f"  dist BA over {n_devices} cards: cost {c_d[0]:.6g} -> "
        f"{c_d[1]:.6g}, one card {c_1[0]:.6g} -> {c_1[1]:.6g} "
        f"(rel {rel0:.2e}, {rel:.2e})")
    check(c_d[1] < c_d[0], "distributed BA lowers cost")
    check(rel0 < 1e-4, "distributed BA initial cost == single-card")
    check(rel < 5e-2, "distributed BA final cost ~ single-card (rel 5%)")

    cam, cfg, frames, _gt = vo_inputs(sz, rng)
    vo_m = MonoVO(cam, cfg, mesh=mesh)
    vo_m.process_batch(frames)
    vo_1 = MonoVO(cam, cfg)
    vo_1.process_batch(frames)
    d = float(np.abs(vo_m.positions() - vo_1.positions()).max())
    log(f"  MonoVO(mesh) vs MonoVO(): keyframes {vo_m.kf_count}/"
        f"{vo_1.kf_count}, max |d| {d:.2e}")
    check("scan_dispatch" in vo_m.monitor.timers,
          "mesh-attached driver takes the scan path")
    check(d < 5e-3, "mesh VO trajectory == single-card (atol 5e-3)")
    return {"dist_ba_rel": rel, "mesh_vo_max_abs": d}


# ---------------------------------------------------------------------------

def _timed(name, fn, *args):
    log(f"[{name}]")
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path (distributed BA, mesh VO)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # the CPU backend is the reference: keep it next to a pinned platform
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    n_need = 4 if args.four_cards else 1
    if len(jax.devices()) < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, JAX found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    from dr3_tpu.utils.cache import enable_persistent_cache

    cache = enable_persistent_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
        f"matmul precision {jax.config.jax_default_matmul_precision}, "
        f"compile cache {cache}")

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(args.seed)
    sz = FULL
    if args.four_cards:
        _timed("four cards", phase_four_cards, sz, rng)
    else:
        _timed("ops", phase_ops, dev, cpu, sz, rng)
        _timed("vo", phase_vo, dev, sz, rng)
        _timed("ba", phase_ba, dev, cpu, sz, rng)
        _timed("panorama", phase_panorama, dev, cpu, sz, rng)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
