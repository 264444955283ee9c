"""Device-time profile of the VO scan program, stage by stage.

    python tools/profile_general_step.py [--seed 0] [--out chiprun_out/profile]

Runs ``MonoVO.process_batch`` over the chip-smoke VO fixture (64 rendered
KITTI-size frames, 1240x376), warms every program on the first half, and
traces the second half with ``jax.profiler``. Each device kernel in the
trace is attributed to the front-end stage whose named scope its HLO
instruction carries (``pyramid``, ``sparse_align``, ``lk``,
``template_align``, ``pose_gn``; keyframe work as ``keyframe``,
``window_ba`` and ``loop_db``), through the op names of the compiled scan
program. XLA's command buffers (CUDA graphs) are turned off for this run,
because kernels replayed inside a graph carry no HLO instruction name.
Prints the window's Monitor report and one JSON object: device time per
stage, the window's wall time, and the device busy share. Needs an
accelerator.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (stage, op-name path component that marks it), most specific first
STAGES = (("template_align", "template_align"), ("lk", "lk"),
          ("sparse_align", "jit(_sparse_align_step)"),
          ("pose_gn", "jit(_pose_optimize)"), ("pyramid", "pyramid"),
          ("window_ba", "jit(_local_ba)"), ("keyframe", "jit(_keyframe_step)"),
          ("loop_db", "jit(insert_and_query)"))
GENERAL = ("pyramid", "sparse_align", "lk", "template_align", "pose_gn")

_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')


def op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> op_name metadata of a compiled program."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def stage_of(op_name: str) -> str:
    parts = op_name.split("/")
    for stage, mark in STAGES:
        if mark in parts:
            return stage
    return "other"


def device_events(xspace_path: str):
    """[(line name, event name, start ns, duration ns, stats)] of the device
    planes of a profiler trace."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xspace_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for e in line.events:
                out.append((line.name, e.name, e.start_ns, e.duration_ns,
                            dict(e.stats)))
    return out


def busy_ns(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    args = ap.parse_args(argv)

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    from dr3_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import glob

    import jax

    import chip_smoke
    from dr3_tpu.pipelines import vo as vo_mod

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("profile_general_step: needs an accelerator", file=sys.stderr)
        return 2
    cam, cfg, frames, _gt = chip_smoke.vo_inputs(
        chip_smoke.FULL, np.random.default_rng(args.seed))
    half = len(frames) // 2
    vo = vo_mod.MonoVO(cam, cfg)
    vo.process_batch(frames[:half])            # bootstrap + compile

    a, kw = vo.scan_args(frames[half:half + cfg.frames_per_dispatch])
    names = op_names(vo_mod._scan_frames.lower(*a, **kw).compile().as_text())

    os.makedirs(args.out, exist_ok=True)
    n0 = vo.frame_idx
    vo.monitor = type(vo.monitor)()           # window-only stage timers
    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        vo.process_batch(frames[half:])
        wall = time.perf_counter() - t0
    print(vo.report())
    n_kf = sum(1 for s in vo.stats[n0 + 1:] if s.is_keyframe)

    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    events = device_events(path)
    lines = sorted({ln for ln, *_ in events})
    # kernels: events that name an HLO instruction of the scan program
    kern = [(ln, nm, s, d, st) for ln, nm, s, d, st in events
            if str(st.get("hlo_module", "")).startswith("jit__scan_frames")
            and "hlo_op" in st]
    per_stage: dict[str, float] = {}
    for _ln, _nm, _s, d, st in kern:
        tf_op = str(st.get("tf_op", ""))
        stage = stage_of(tf_op if "/" in tf_op
                         else names.get(str(st["hlo_op"]), ""))
        per_stage[stage] = per_stage.get(stage, 0.0) + d
    scan_ns = sum(per_stage.values())
    general_ns = sum(per_stage.get(k, 0.0) for k in GENERAL)
    lk_ns = per_stage.get("lk", 0.0) + per_stage.get("template_align", 0.0)
    busy = busy_ns([(s, s + d) for _ln, _nm, s, d, _st in events])
    top: dict[str, float] = {}
    for _ln, nm, _s, d, st in kern:
        top[nm] = top.get(nm, 0.0) + d
    result = {
        "device": dev.device_kind,
        "frames": len(frames) - half, "keyframes": n_kf,
        "wall_s": wall,
        "device_busy_share": busy / (wall * 1e9),
        "scan_device_ms": scan_ns / 1e6,
        "stage_device_ms": {k: v / 1e6 for k, v in sorted(per_stage.items())},
        "lk_plus_template_share_of_general_step": lk_ns / max(general_ns, 1),
        "lk_plus_template_share_of_scan": lk_ns / max(scan_ns, 1),
        "device_lines": lines,
        "top_kernels_ms": {k: v / 1e6 for k, v in
                           sorted(top.items(), key=lambda kv: -kv[1])[:25]},
    }
    with open(os.path.join(args.out, "events_sample.txt"), "w") as fh:
        for ev in (kern or events)[:200]:
            fh.write(repr(ev) + "\n")
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
