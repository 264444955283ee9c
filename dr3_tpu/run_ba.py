"""Offline bundle adjustment over BAL problem files (the JAX
counterpart of the reference's Ceres BAL adjuster, tests/ceres/ba.cc:21-167).

    python -m dr3_tpu.run_ba problem.bal --iters 30 --out refined.bal \
        --render cloud.png

Reads Snavely's BAL text format and solves it with the jitted
Schur-complement LM. Two camera models:

* ``--model snavely`` (default): the exact 9-param BAL objective —
  per-camera focal + k1/k2 radial (ba/snavely.py), cost-comparable with
  Ceres on the same file (reference ba.cc:105-118).
* ``--model pinhole``: lossy conversion to the in-repo shared-intrinsics
  pinhole problem (median focal, radial dropped) — the reference's *in-repo*
  OptProblem layout (src/optimizer.cpp:29-41). ``--optimize-intrinsics``
  additionally solves for the shared (fx, fy, cx, cy) block, matching
  src/optimizer.cpp:144-153.

Large camera counts automatically switch the reduced camera solve to
matrix-free PCG with the SCHUR_JACOBI preconditioner; memory stays
O(observations), so real BAL files (hundreds of cameras, 10^5+ points) fit
on one chip.
"""

from __future__ import annotations

# direct-script invocation (python dr3_tpu/run_X.py) from any cwd: put the
# repo root on sys.path so the package imports resolve
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bal", help="BAL problem file")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--model", choices=("snavely", "pinhole"),
                    default="snavely")
    ap.add_argument("--huber", type=float, default=0.0,
                    help="Huber scale in pixels (0 = plain L2, Ceres-default "
                         "parity; the reference BA has no robust loss)")
    ap.add_argument("--optimize-intrinsics", action="store_true",
                    help="pinhole model: solve the shared 4-param "
                         "intrinsics block too")
    ap.add_argument("--solver",
                    choices=("auto", "explicit", "zexplicit", "pcg"),
                    default="auto")
    ap.add_argument("--out", default=None, help="write refined BAL here")
    ap.add_argument("--render", default=None,
                    help="render refined cloud + camera frusta to this PNG")
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    args = ap.parse_args(argv)

    from dr3_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from dr3_tpu.parallel.mesh import distributed_init

    distributed_init()  # multi-host launch contract (no-op single-process)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from dr3_tpu.io.bal import load_bal, save_bal

    data = load_bal(args.bal)
    huber = args.huber if args.huber > 0 else 1e9

    if args.model == "snavely":
        from dr3_tpu.ba.snavely import (bal_to_snavely, bundle_adjust_snavely,
                                        snavely_to_bal)

        prob = bal_to_snavely(data)
        print(f"loaded {prob.n_cams} cams, {prob.n_points} points, "
              f"{prob.n_obs} observations from {args.bal} (snavely model)")
        t0 = time.perf_counter()
        res = bundle_adjust_snavely(prob, args.iters, huber_delta=huber,
                                    solver=args.solver)
        jax.block_until_ready(res.final_cost)
        to_bal = snavely_to_bal
    else:
        from dr3_tpu.ba.schur_lm import bundle_adjust
        from dr3_tpu.io.bal import bal_to_problem, problem_to_bal

        prob = bal_to_problem(data)
        print(f"loaded {prob.n_cams} cams, {prob.n_points} points, "
              f"{prob.n_obs} observations from {args.bal} (pinhole model)")
        t0 = time.perf_counter()
        res = bundle_adjust(prob, args.iters, huber_delta=huber,
                            optimize_intrinsics=args.optimize_intrinsics,
                            solver=args.solver)
        jax.block_until_ready(res.final_cost)
        to_bal = problem_to_bal

    dt = time.perf_counter() - t0
    it_s = args.iters / dt
    print(f"cost: {float(res.initial_cost):.6g} -> "
          f"{float(res.final_cost):.6g} "
          f"({int(res.n_accepted)}/{args.iters} steps accepted, "
          f"{dt:.2f}s incl. compile, {it_s:.1f} LM iters/s)")

    if args.out:
        save_bal(args.out, to_bal(res.problem))
        print(f"wrote {args.out}")
    if args.render:
        from dr3_tpu.geometry.lie import SE3
        from dr3_tpu.viz.draw3d import render_map

        T = SE3(res.problem.cam_wxyz, res.problem.cam_t)
        centers = np.asarray(T.inverse().t)
        render_map(centers, np.asarray(res.problem.points),
                   path=args.render)
        print(f"wrote {args.render}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
