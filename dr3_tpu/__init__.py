"""dr3_tpu — a JAX SLAM / SfM / panorama framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of kvmanohar22/3DR
(reference mounted at /root/reference): 2D image transforms + spherical /
cylindrical warping, pairwise alignment and stitching, multi-image panoramas,
two-view epipolar geometry, monocular visual odometry / SLAM on KITTI, and
bundle adjustment — rebuilt as batched accelerator programs:

* world state is struct-of-arrays with static shapes + masks (no pointer webs),
* every hot op is a batched, jit-compiled kernel (vmapped RANSAC, batched
  triangulation, dense warp kernels, pyramidal LK as fixed-iteration GN),
* bundle adjustment is a JAX-native Levenberg-Marquardt on the Schur
  complement (replacing Ceres DENSE_SCHUR), shardable over a device mesh with
  psum/reduce-scatter collectives over ICI,
* observability is named stage timers + per-frame reports (Monitor parity with
  reference include/timer.hpp) and offline PNG rendering instead of Pangolin.

Package layout:
  dr3_tpu.geometry   SO3/SE3 Lie groups, epipolar geometry, homography, RANSAC
  dr3_tpu.models     camera models (pinhole + radial/tangential distortion)
  dr3_tpu.ops        image kernels: pyramid, FAST, Shi-Tomasi, LK, warps, blend
  dr3_tpu.ba         JAX-native bundle adjustment (Schur LM), pose graph
  dr3_tpu.parallel   device-mesh helpers + distributed BA
  dr3_tpu.pipelines  stitch, panorama, two-view init, VO/SLAM drivers
  dr3_tpu.io         KITTI + image IO (native C++ prefetching loader + PIL)
  dr3_tpu.viz        offline 2D/3D result rendering (PNG artifacts)
  dr3_tpu.utils      config, timing/monitoring, misc
"""

__version__ = "0.1.0"

import jax as _jax

# On the GPU, XLA may run f32 matmuls in TF32 (a 10-bit mantissa) —
# fatal for geometry: 8-point systems, triangulation and BA normal
# equations lose about 13 bits, enough to move epipolar residuals by ~1 px
# and fail the two-view bootstrap. Default the whole framework to full
# f32 matmuls; kernels that tolerate lower precision opt in with an
# explicit precision=.
_jax.config.update("jax_default_matmul_precision", "highest")

from dr3_tpu.utils.config import Config  # noqa: F401
