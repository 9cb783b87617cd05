"""Transport and shading: milliseconds a frame of device time spent in
operations that are not the port's hand-written kernels (the
`__global__` functions of its csrc/*.cu): torch's elementwise,
reduction, sort and indexing kernels and the copies, summed over their
own durations."""


def read(ctx):
    t = ctx.trace
    if not t or not t["ops"]:
        return None
    total = sum(s for s, _n in t["by_name"].values())
    return (total - t["hand_s"]) / t["frames"] * 1e3
