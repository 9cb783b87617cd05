"""Device: the share of the traced frames' wall time in which no
operation ran on the card, 1 - (union of the device's intervals) /
(host-clock time over the traced frames), in percent."""


def read(ctx):
    t = ctx.trace
    if not t or t["wall_s"] <= 0 or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
