"""Host launch path: the share of the traced frames' tiles that replayed
a tile graph (the port's render/graphs.py: a tile's launches as one CUDA
graph), the port's counter `graph_tiles` over its `tiles`, as the root
span `frame` carries both.  A port without the counter reads nothing."""


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
    roots = [f.spans[0].attrs for f in frames]
    tiles = sum(a.get("tiles", 0) for a in roots)
    if not tiles or any("graph_tiles" not in a for a in roots):
        return None
    return sum(a["graph_tiles"] for a in roots) / tiles
