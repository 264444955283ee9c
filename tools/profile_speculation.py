"""A/B the scan driver's speculative-chain depth on chip.

Measures steady-state fps of `process_batch` over already-mapped content
at speculation depth 1/2/3, plus whether copy_to_host_async actually
works on this platform (if it raises, every fetch falls back to a
blocking np.asarray that drains the whole dispatch queue — speculation
then buys nothing)."""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from dr3_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    x = jnp.arange(8.0)
    try:
        x.copy_to_host_async()
        print("copy_to_host_async: OK (no exception)", flush=True)
    except Exception as e:
        print(f"copy_to_host_async: RAISES {type(e).__name__}: {e}",
              flush=True)

    from dr3_tpu.io.kitti import open_fixture_sequence
    from dr3_tpu.models.camera import Pinhole
    from dr3_tpu.pipelines.vo import MonoVO
    from dr3_tpu.utils.config import Config

    seq = open_fixture_sequence()
    base = [np.asarray(seq.frame(i), np.float32) for i in range(len(seq))]
    palindrome = base + base[-2:0:-1]
    palindrome = [np.clip(f * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
                  for f in palindrome]
    n_total = 416
    frames = [palindrome[i % len(palindrome)] for i in range(n_total)]

    for depth in (1, 2, 3):
        cfg = Config(loop_min_gap_frames=20, loop_db_capacity=24,
                     frames_per_dispatch=32, scan_transfer_uint8=True,
                     scan_speculation_depth=depth)
        vo = MonoVO(Pinhole.kitti(), cfg)
        warm = 0
        while warm < 256:
            vo.process_batch(frames[warm:warm + 32])
            warm = vo.frame_idx + 1
        t0 = time.perf_counter()
        vo.process_batch(frames[warm:])
        dt = time.perf_counter() - t0
        fetch = vo.monitor.timers.get("scan_fetch")
        print(f"depth {depth}: {(n_total - warm) / dt:6.2f} fps steady "
              f"(fetch avg {1e3 * fetch.average:.0f} ms over {fetch.n})",
              flush=True)


if __name__ == "__main__":
    main()
