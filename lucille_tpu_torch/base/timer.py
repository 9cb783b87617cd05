"""Named-timer registry, and the spans and counters of a frame.

Equivalent capability to lucille's `src/base/timer.{c,h}`: a hash of named
timers with start/end/elapsed and a dump at frame end (timer.h:56-78,
render.c:1243).  The port times "RIB parsing" (cli.py), "Scene compile",
"Render frame" and "Imager" (render/renderer.py), "BVH Construction" and
"Grid Construction" (scene/compile.py); `lsh --stats` prints them.  The
entries accumulate host wall time: a device phase ends where the host
has its result (the renderer's pulls), not where it was enqueued.

Spans.  Inside `Timer.frame()` (one a `Renderer.render_frame`), the
renderer and the accel wrappers open named spans (`span`, `traced`):

    frame                 the root; its attrs carry the frame's counters
                          (host_syncs, device.host_sync's count;
                          graph_tiles, the tiles that replayed a tile
                          graph) and tiles (its `tile` spans)
      frame.enqueue       every tile of the frame enqueued on the device
        tile (x0, y0)     Renderer._tile
          tile.capture    a tile graph's capture (render/graphs.py)
          tile.rays       the tile's stream, lens draw and eye rays; in a
                          replayed tile, its draws into the graph's
                          buffers
          tile.integrate  the integrator call; in a replayed tile, the
                          graph's replay
            accel.<fn>    each kernel launch wrapper and plain twin (an
                          eager tile's only)
          tile.filter     atmosphere, pixel filter, counters, alpha (an
                          eager tile's only)
      tile.pull           the wait for a tile's copies to the host
                          (mesh._Round)
      tile.deliver        crop and copy into the frame, checkpoint,
                          tile_cb, progress_cb
      frame.imager        the imager over the assembled frame

A frame records exactly while a torch profiler runs in the process:
`frame()` checks once, at the frame's start, and the answer holds for
the frame.  Recording off, a span is one flag check and a shared no-op
context.  Recording on, each span keeps its name, start and end
(time.perf_counter_ns), its parent and its attrs in memory, and also
enters the profiler's timeline as a CPU-only range (a record function
that is not a user annotation, so the profiler mirrors nothing of it
onto the device), beside the torch ops and kernels it encloses.  The
last MAX_FRAMES frames are kept; `recorded_frames(n)` reads them.  The
benchmark's per-layer metrics enqueue_ms, pull_wait_ms, glue_host_ms
and host_syncs read them (benchmark/metrics/), and `lsh --profile FILE
--stats` prints each span's self time a frame (`span_report`).

The port's copy of lucille_tpu/base/timer.py, with the spans added.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from functools import wraps

import torch

# a CPU range in the profiler's timeline that it never mirrors onto the device
from torch._C._profiler import _RecordFunctionFast as _ProfilerRange

MAX_FRAMES = 64  # the frames whose spans are kept

_NOOP = nullcontext()


def _profiler_running() -> bool:
    return torch._C._autograd._profiler_enabled()


@dataclass
class _Entry:
    elapsed: float = 0.0
    count: int = 0
    _start: float | None = None


@dataclass(slots=True)
class Span:
    """One span of a recorded frame: its name, start and end on
    time.perf_counter_ns, the index of its parent in the frame's spans
    (-1 for the root) and its attrs."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: dict


@dataclass
class FrameTrace:
    """A recorded frame: its id (frames counted from 0 in the process),
    its spans in the order they opened (spans[0] is the root, "frame")
    and its counters."""

    id: int
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=lambda: defaultdict(int))
    _stack: list = field(default_factory=list, repr=False)

    def self_seconds(self) -> dict:
        """{span name: seconds} of each span's own time, its duration
        less its children's, summed over the frame."""
        own = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                own[s.parent] -= s.end_ns - s.start_ns
        out = defaultdict(float)
        for s, ns in zip(self.spans, own):
            out[s.name] += ns * 1e-9
        return dict(out)


class _OpenSpan:
    """A span being recorded in `frame`: entered, it opens the profiler's
    range, then starts its clock under its parent; left, it stops its
    clock, then closes the range."""

    __slots__ = ("_frame", "_span", "_range")

    def __init__(self, frame: FrameTrace, name: str, attrs: dict):
        self._frame = frame
        self._span = Span(name, 0, 0, -1, attrs)
        self._range = _ProfilerRange(name)

    def __enter__(self) -> Span:
        self._range.__enter__()
        fr, span = self._frame, self._span
        span.parent = fr._stack[-1] if fr._stack else -1
        fr._stack.append(len(fr.spans))
        fr.spans.append(span)
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        self._span.end_ns = time.perf_counter_ns()
        self._frame._stack.pop()
        self._range.__exit__(*exc)
        return False


class _FrameScope:
    """The root span of a recorded frame; left, it puts the frame's
    counters and its tile count on the root and keeps the frame."""

    def __init__(self, timer: "Timer"):
        self._timer = timer
        self._frame = FrameTrace(timer._frame_count)
        timer._frame_count += 1
        self._root = _OpenSpan(self._frame, "frame", {})

    def __enter__(self) -> Span:
        self._timer._frame = self._frame
        return self._root.__enter__()

    def __exit__(self, *exc):
        fr = self._frame
        self._root.__exit__(*exc)
        self._timer._frame = None
        fr.counters = dict(fr.counters)
        fr.spans[0].attrs.update(
            fr.counters, tiles=sum(s.name == "tile" for s in fr.spans))
        self._timer._frames.append(fr)
        return False


@dataclass
class Timer:
    """A registry of named accumulating timers, and the recorded frames'
    spans and counters (module docstring)."""

    entries: dict[str, _Entry] = field(default_factory=dict)
    _frame: FrameTrace | None = field(default=None, repr=False)
    _frames: deque = field(default_factory=lambda: deque(maxlen=MAX_FRAMES),
                           repr=False)
    _frame_count: int = field(default=0, repr=False)
    _launches: set | None = field(default=None, repr=False)

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

    # -- the frame's spans and counters ------------------------------------

    def frame(self):
        """The root span of one frame: recorded, with everything opened
        inside it, when a torch profiler runs as it starts (a no-op
        context otherwise, and inside a frame already open).  Entered,
        it gives the root Span, or None when not recording."""
        if self._frame is not None or not _profiler_running():
            return _NOOP
        return _FrameScope(self)

    def span(self, name: str, **attrs):
        """A span named `name` under the innermost open span of the
        recording frame, with `attrs`; a no-op context when no frame is
        recording.  Entered, it gives its Span, or None."""
        if self._frame is None:
            return _NOOP
        return _OpenSpan(self._frame, name, attrs)

    @contextmanager
    def paused(self):
        """Inside the block nothing is recorded (render/graphs.py)."""
        frame, self._frame = self._frame, None
        try:
            yield
        finally:
            self._frame = frame

    @contextmanager
    def recording_launches(self):
        """Inside the block each `traced` function called is added to the
        set it gives (render/graphs.py)."""
        saved, self._launches = self._launches, set()
        try:
            yield self._launches
        finally:
            self._launches = saved

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the recording frame's counter `name` (nothing when no
        frame is recording)."""
        if self._frame is not None:
            self._frame.counters[name] += n

    def recorded_frames(self, n: int | None = None) -> list:
        """The last n recorded frames (all that are kept when n is None),
        oldest first, as FrameTrace: each frame's spans and counters."""
        frames = list(self._frames)
        return frames if n is None else frames[max(0, len(frames) - n):]

    def span_report(self, frames) -> str:
        """Each span's self time a frame, in ms, over the given recorded
        frames, largest first; then each counter a frame."""
        total, counts = defaultdict(float), defaultdict(int)
        for fr in frames:
            for name, s in fr.self_seconds().items():
                total[name] += s
            for name, c in fr.counters.items():
                counts[name] += c
        n = max(1, len(frames))
        lines = [f"= Span self time, ms a frame ({len(frames)} frames) "
                 + "=" * 16]
        for name, s in sorted(total.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<40s} {s / n * 1e3:10.3f}")
        for name, c in sorted(counts.items()):
            lines.append(f"  {name + ' (count)':<40s} {c / n:10.1f}")
        lines.append("=" * 59)
        return "\n".join(lines)


_global_timer = Timer()


def get_timer() -> Timer:
    return _global_timer


def traced(name: str):
    """Decorator: each call of the function runs inside span `name` of
    the global timer (a flag check when no frame is recording)."""

    def wrap(fn):
        @wraps(fn)
        def call(*args, **kwargs):
            if _global_timer._launches is not None:
                _global_timer._launches.add(call)
            if _global_timer._frame is None:
                return fn(*args, **kwargs)
            with _OpenSpan(_global_timer._frame, name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap
