"""The traced frames: torch.profiler over a fixed count of frames inside
the window, reduced to what the per-layer readers and the result line
take.

The arithmetic is profile_frame.py's at commit d8e7cf1 (:142-185): the
device is busy in the union of its kernel and copy intervals, idle in
the rest of the profiled wall time, and its operations are the
profiler's device events.  The port's hand-written kernels are the
`__global__` functions of its csrc/*.cu, read from the sources the run
loads, so every other device operation is glue.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from pathlib import Path

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def hand_kernel_names(package_dir: Path) -> set:
    """The `__global__` functions of the program's CUDA sources."""
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def kernel_pattern(names) -> re.Pattern:
    """Matches a profiler event named after one of `names` (a CUDA
    symbol as the profiler prints it: 'void ao_kernel<16, ...>(...)')."""
    alt = "|".join(sorted(map(re.escape, names))) or r"(?!x)x"
    return re.compile(rf"\b(?:{alt})\s*[<(]")


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] between the merged intervals."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def _host_doing(cpu, starts, t):
    """The innermost host operation running at time t: the one that
    started last among those still running."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 20000), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "host (no operation recorded)"


def profile_frames(render, frames: int, hand: set, top: int = 10) -> dict:
    """Run render() `frames` times under torch.profiler (CPU and CUDA
    activity) and reduce the trace: {"frames", "wall_s" (host clock over
    the frames, ended by a synchronize), "busy_s", "ops", "by_name"
    {device op: [seconds, count]}, "hand_s" (device seconds of the hand
    kernels), "breakdown" {"device_ops", "idle_gaps"}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    card = torch.cuda.is_available()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            render()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CUDA]
    cpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type != DeviceType.CUDA)
    by_name = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        by_name[name][0] += (b - a) / 1e6
        by_name[name][1] += 1
    pat = kernel_pattern(hand)
    hand_s = sum(s for name, (s, _n) in by_name.items() if pat.search(name))
    spans = [(a, b) for a, b, _ in dev]
    lo = min([c[0] for c in cpu] + [a for a, _ in spans] or [0.0])
    hi = max([c[1] for c in cpu] + [b for _, b in spans] or [0.0])
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for a, b in sorted(_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:500]:
        idle[_host_doing(cpu, starts, (a + b) / 2)] += (b - a) / 1e6
    return {
        "frames": frames, "wall_s": wall,
        "busy_s": union_length(spans) / 1e6, "ops": len(dev),
        "by_name": dict(by_name), "hand_s": hand_s,
        "breakdown": {
            "device_ops": [[n[:120], s] for n, (s, _c) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:top]],
            "idle_gaps": [[n[:120], s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
