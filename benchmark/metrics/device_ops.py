"""Host launch path: device operations a frame, from the traced frames
(every kernel and copy the profiler saw on the card, over the frames
traced)."""


def read(ctx):
    t = ctx.trace
    if not t or not t["ops"]:
        return None
    return t["ops"] / t["frames"]
