"""Named-timer registry for per-phase profiling.

Equivalent capability to lucille's `src/base/timer.{c,h}`: a hash of named
timers with start/end/elapsed and a dump at frame end (timer.h:56-78,
render.c:1243).  Phases timed by the renderer mirror the reference:
"RIB parsing", "BVH Construction", "Render frame", "TOTAL rendering time".

Device work is asynchronous under JAX, so the renderer calls
``block_until_ready`` before ``end()`` on device phases; wall-clock numbers
therefore include real device time, not dispatch time.

The port's copy of lucille_tpu/base/timer.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class _Entry:
    elapsed: float = 0.0
    count: int = 0
    _start: float | None = None


@dataclass
class Timer:
    """A registry of named accumulating timers."""

    entries: dict[str, _Entry] = field(default_factory=dict)

    def start(self, name: str) -> None:
        self.entries.setdefault(name, _Entry())._start = time.perf_counter()

    def end(self, name: str) -> float:
        e = self.entries.get(name)
        if e is None or e._start is None:
            return 0.0
        dt = time.perf_counter() - e._start
        e.elapsed += dt
        e.count += 1
        e._start = None
        return dt

    def elapsed(self, name: str) -> float:
        e = self.entries.get(name)
        return e.elapsed if e else 0.0

    def dump(self, out=None) -> str:
        """Render the per-phase report (reference ri_timer_dump, timer.c)."""
        lines = ["= Timer statistics ========================================"]
        for name, e in sorted(self.entries.items(), key=lambda kv: -kv[1].elapsed):
            lines.append(f"  {name:<40s} {e.elapsed:10.3f} sec ({e.count} calls)")
        lines.append("===========================================================")
        report = "\n".join(lines)
        if out is not None:
            print(report, file=out)
        return report

    class _Scope:
        def __init__(self, timer: "Timer", name: str):
            self._timer, self._name = timer, name

        def __enter__(self):
            self._timer.start(self._name)
            return self

        def __exit__(self, *exc):
            self._timer.end(self._name)
            return False

    def scope(self, name: str) -> "Timer._Scope":
        return Timer._Scope(self, name)


_global_timer = Timer()


def get_timer() -> Timer:
    return _global_timer
