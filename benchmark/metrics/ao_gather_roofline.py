"""Kernels 3 and 3b (csrc/ao.cu `ao_kernel`, launched by
accel/ao.ao_occlusion_kernel): the least time the card could take for
the dense AO gather's needed work over the kernel's device time, both a
frame's, in percent.

The need is the frozen `gather_need` (harness/need.py) on the frame's
own launches (harness/capture.py): per launch, a fixed-seed draw of up
to SAMPLE live lanes, its box and triangle tests scaled to all live
lanes; ops = tests x AO_OPS + box tests x SLAB_OPS; bytes = the lanes'
rays, jitter and count in and out (bits too), every slot's triangle
once, the boxes once (chip_smoke.check_gather's count at d8e7cf1).  The
bound is max(ops / PEAK_FLOPS, bytes / PEAK_BYTES); the kernel's time is
the traced frames' `ao_kernel` device time a frame."""

SAMPLE = 16384


def read(ctx):
    import torch

    from harness.need import (
        AO_OPS, PEAK_BYTES, PEAK_FLOPS, SLAB_OPS, gather_need)

    launches = ctx.captures.get("ao_gather") or []
    kernel_s = ctx.kernel_seconds("ao_kernel")
    if not launches or not kernel_s:
        return None
    bound_s = 0.0
    for ln in launches:
        scene, rays, jitter = ln["scene"], ln["rays"], ln["jitter"]
        n = int(ln["nact"])
        B = rays.shape[1]
        ops = 0.0
        if n:
            gen = torch.Generator(device=rays.device).manual_seed(7)
            pick = torch.randperm(n, device=rays.device,
                                  generator=gen)[:SAMPLE]
            r = rays[:, pick]
            need = gather_need(scene, r[0:3].T, r[3:6].T, r[6:9].T,
                               r[9:12].T, jitter[:, pick], ln["ntheta"],
                               ln["nphi"])
            scale = n / pick.numel()
            ops = scale * (need["tests"] * AO_OPS
                           + (need["tiles"] + need["groups"]) * SLAB_OPS)
        rows = -(-ln["ntheta"] * ln["nphi"] // 32)
        nbytes = (B * (48 + 8 + 4) + scene.n_pad * 48
                  + (scene.boxes.shape[1] + scene.sub_boxes.shape[1]) * 32
                  + (B * 4 * rows if ln["want_bits"] else 0))
        bound_s += max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    return 100.0 * bound_s / kernel_s
