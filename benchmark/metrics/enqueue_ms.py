"""Host launch path: milliseconds a frame the host takes to enqueue the
frame's tiles, the port's span `frame.enqueue` (render/renderer.py:
every tile's rays, integrator and filter handed to the device, before
the first pull), over the traced frames."""


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
             if s.name == "frame.enqueue")
    return ns / len(frames) * 1e-6
