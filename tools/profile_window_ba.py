"""Chip timing of the window-BA Schur solvers at production shapes.

Times `bundle_adjust` (32 kf x 16384 pts x 17472 obs — the in-scan
`_local_ba` problem) per LM iteration for each Schur method, timed to a
value fetch. Run on the chip to pick the in-scan default.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from dr3_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from dr3_tpu.ba.schur_lm import bundle_adjust
    from dr3_tpu.io.synth import window_ba_problem

    rng = np.random.default_rng(0)
    prob = window_ba_problem(rng)
    iters = int(os.environ.get("PROF_ITERS", "8"))
    reps = int(os.environ.get("PROF_REPS", "5"))

    # cfg-default pcg settings (pipelines/vo.py _local_ba), then the two
    # exact paths
    settings = [
        ("pcg(cfg)", dict(solver="pcg", cg_iters=64, cg_tol=1e-2,
                          q_eta=0.1)),
        ("explicit", dict(solver="explicit")),
        ("zexplicit", dict(solver="zexplicit")),
    ]
    for name, kw in settings:
        res = bundle_adjust(prob, iters, **kw)  # warmup/compile
        c_warm = float(res.final_cost)
        t0 = time.perf_counter()
        for _ in range(reps):
            res = bundle_adjust(prob, iters, **kw)
            cost = float(res.final_cost)
        dt = time.perf_counter() - t0
        print(f"{name:10s}: {reps * iters / dt:7.2f} LM iters/s "
              f"({dt / reps * 1e3 / iters:6.2f} ms/iter)  final_cost="
              f"{cost:.2f} accepted={int(res.n_accepted)}/{iters}",
              flush=True)
        assert abs(cost - c_warm) < 1e-3 * max(abs(c_warm), 1.0)


if __name__ == "__main__":
    main()
