"""Host launch path: milliseconds a frame the host spends in the pulls,
the port's spans `tile.pull` (parallel/mesh.py `_Round.get`: a tile's
image and counters copied to the host, each copy waiting for the device
to reach it), summed over the traced frames' tiles."""


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
    ns = sum(s.end_ns - s.start_ns for f in frames for s in f.spans
             if s.name == "tile.pull")
    return ns / len(frames) * 1e-6
