"""Kernel 5 (csrc/bvh.cu `bvh_any_kernel`, launched by
accel/bvh_isect.bvh_any_hit): the least time the card could take for the
tile-BVH any-hit's needed work over the kernel's device time, both a
frame's, in percent.

The need is the frozen `need_walk` (harness/need.py) on N_NEED rays of
each of the frame's launches, drawn with a fixed seed
(harness/capture.py), scaled to the launch's rays: ops = (triangle tests
x SV_OPS + inner nodes entered x NODE_OPS) x scale; bytes = every ray in
(origin, direction, tmax) and its answer out, plus the nodes and real
leaf triangles the sample reaches (chip_smoke.check_bvh_kernels' count
at d8e7cf1).  The bound is max(ops / PEAK_FLOPS, bytes / PEAK_BYTES);
the kernel's time is the traced frames' `bvh_any_kernel` device time a
frame."""


def read(ctx):
    from harness.need import (
        NODE_OPS, PEAK_BYTES, PEAK_FLOPS, SV_OPS, need_walk, reached_bytes)

    launches = ctx.captures.get("bvh_anyhit") or []
    kernel_s = ctx.kernel_seconds("bvh_any_kernel")
    if not launches or not kernel_s:
        return None
    bound_s = 0.0
    for ln in launches:
        if ln["bounded"]:
            return None  # the frozen walk counts unbounded gathers only
        need = need_walk(ln["tris"], ln["nodes"], ln["org"], ln["dirn"],
                         False, ln["depth"])
        scale = ln["rays"] / ln["org"].shape[0]
        ops = scale * (need["tests"] * SV_OPS + need["inner"] * NODE_OPS)
        nbytes = ln["rays"] * (28 + 1) + reached_bytes(need)
        bound_s += max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    return 100.0 * bound_s / kernel_s
