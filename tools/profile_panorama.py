"""Chip timing of the panorama pipeline stages (spherical pre-warp,
pairwise alignment, paste/blend) plus the per-run total, three times to
see the spread. Prints the Monitor stage table per repetition."""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from dr3_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from dr3_tpu.io.image import load_image_dir
    from dr3_tpu.pipelines.panorama import Panorama, PanType

    d = "/root/reference/imgs/field"
    images = load_image_dir(d)
    print(f"{len(images)} images, shapes: {sorted({im.shape for im in images})}",
          flush=True)
    pan = Panorama(focal_length=600.0, pan_type=PanType.TRANSLATE,
                   feathering_width=40)
    out = pan.process(images)  # warmup/compile
    print("warm done", out.shape, flush=True)
    for rep in range(3):
        pan.monitor = type(pan.monitor)()
        t0 = time.perf_counter()
        out = pan.process(images)
        float(np.asarray(out).mean())
        dt = time.perf_counter() - t0
        stages = {n: round(1e3 * t.total, 1)
                  for n, t in pan.monitor.timers.items()}
        print(f"rep {rep}: {dt:.2f}s total, {len(images) / dt:.2f} img/s, "
              f"stage ms: {stages}", flush=True)


if __name__ == "__main__":
    main()
