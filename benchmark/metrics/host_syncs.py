"""Host launch path: the times a frame the host waits on the card, the
port's counter `host_syncs` (device.host_sync: the pulls' copies to the
host, the frame's constants copied to the card), as the root span
`frame` carries it, over the traced frames."""


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
    return sum(f.spans[0].attrs.get("host_syncs", 0)
               for f in frames) / len(frames)
