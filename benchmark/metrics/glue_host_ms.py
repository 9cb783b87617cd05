"""Transport and shading: milliseconds a frame of host time the
integrators spend in their own torch glue, the self time of the port's
spans `tile.integrate` (render/renderer.py): each one's duration less
its `accel.*` children's (the kernel launch wrappers and plain twins,
base/timer.py `traced`), summed over the traced frames' tiles."""


def _frames(ctx):
    """The traced frames' spans from the port's timer (the last
    ctx.trace["frames"] it recorded: the run's other frames run without a
    profiler and record nothing), or None: too few, or a port without
    spans."""
    from lucille_tpu_torch.base.timer import get_timer

    n = ctx.trace["frames"] if ctx.trace else 0
    recorded = getattr(get_timer(), "recorded_frames", None)
    frames = recorded(n) if recorded and n else []
    return frames if n and len(frames) == n else None


def read(ctx):
    frames = _frames(ctx)
    if frames is None:
        return None
    ns = 0
    for f in frames:
        for s in f.spans:
            if s.name == "tile.integrate":
                ns += s.end_ns - s.start_ns
            elif s.name.startswith("accel.") and s.parent >= 0 and (
                    f.spans[s.parent].name == "tile.integrate"):
                ns -= s.end_ns - s.start_ns
    return ns / len(frames) * 1e-6
