"""Re-export of the synthetic renderer, which lives in the package
(:mod:`dr3_tpu.io.synth`) so benchmarks and the chip smoke run can use it."""

from dr3_tpu.io.synth import (NpSE3, _pose_rt, corridor_path,  # noqa: F401
                              forward_trajectory, gt_centers, make_textures,
                              render_corridor, render_scene)
