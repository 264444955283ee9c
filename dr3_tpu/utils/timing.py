"""Named stage timers + per-pipeline reports.

Parity with the reference's Timer/Monitor (include/timer.hpp:17-73,
src/timer.cpp:9-58): string-keyed registry of wall-clock timers with
cumulative and average accounting, plus ``get_tat()`` (sum of averages) and a
per-frame report in the style of src/slam.cpp:49-84.

Device caveat: JAX dispatch is async, so ``toc`` optionally blocks on a result
(``block=result``) so wall-clock covers device execution, not just dispatch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import jax


@dataclass
class Timer:
    name: str
    n: int = 0
    total: float = 0.0
    _t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, block: Any = None) -> float:
        if block is not None:
            jax.block_until_ready(block)
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.n += 1
        self.total += dt
        return dt

    @property
    def average(self) -> float:
        return self.total / self.n if self.n else 0.0


@dataclass
class Monitor:
    """String-keyed timer registry (reference include/timer.hpp:59-73)."""

    timers: Dict[str, Timer] = field(default_factory=dict)

    def add_timer(self, name: str) -> Timer:
        self.timers.setdefault(name, Timer(name))
        return self.timers[name]

    def tic(self, name: str) -> None:
        self.add_timer(name).tic()

    def toc(self, name: str, block: Any = None) -> float:
        return self.add_timer(name).toc(block=block)

    def __getitem__(self, name: str) -> Timer:
        return self.add_timer(name)

    def get_tat(self) -> float:
        """Turn-around time = sum of per-stage averages (src/timer.cpp:53-58)."""
        return sum(t.average for t in self.timers.values())

    def report(self, n_frames: Optional[int] = None, extra: Optional[Dict[str, Any]] = None) -> str:
        """Per-frame stats report (reference SLAM::pprint, src/slam.cpp:49-84)."""
        lines = ["-" * 56, f"{'stage':<28}{'n':>6}{'avg [ms]':>11}{'total [s]':>11}"]
        for name, t in self.timers.items():
            lines.append(f"{name:<28}{t.n:>6}{t.average * 1e3:>11.3f}{t.total:>11.3f}")
        lines.append("-" * 56)
        if n_frames:
            total = self.timers.get("global")
            wall = total.total if total and total.total > 0 else self.get_tat() * n_frames
            if wall > 0:
                lines.append(f"{'FPS':<28}{n_frames / wall:>28.2f}")
        for k, v in (extra or {}).items():
            lines.append(f"{k:<28}{v!r:>28}")
        lines.append("-" * 56)
        return "\n".join(lines)
