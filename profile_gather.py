#!/usr/bin/env python3
"""The dense AO gather's kernel time (csrc/ao.cu) at the three shapes the
main paths give it, for comparing two trees in one call.

    python3 profile_gather.py [TREE]

TREE is the root of a checkout of this repository (default: the
directory of this script).  Its lucille_tpu_torch and chip_smoke are
imported, and its kernels built, so `python3 profile_gather.py
_archive/parent` times an unpacked parent commit with the same shapes
and the same clock.  The shapes, each from TREE's chip_smoke helpers:

(a) headline: the bundled scene's first 240x240 tile at 3x3 samples
    (518,400 lanes; 322 triangles in 4 tiles), 8x8 strata, the counts
    and the counts with bits;
(b) heightfield91: the first 128x128x4 tile of the 16,200-triangle
    terrain (128 tiles), 8x8 strata, both outputs;
(c) whitted-2x2: headline-whitted's first-bounce dome gather on the
    bundled tile, 2x2 strata, the counts.

Each runs through the public gather (`accel.ao.ao_occlusion` /
`ao_occlusion_bits`) REPS times under torch.profiler; the kernel time is
the mean device time of the events named `ao_kernel<...>`, one a call.
Prints the card's nvidia-smi name and power limit and one line per
(shape, output); the instantiations' registers and spills are
chip_smoke.py's to print.  Needs one card; imports nothing of
lucille_tpu.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

REPS = 10


def kernel_ms(fn, reps: int = REPS) -> tuple[float, str]:
    """(mean device ms of the ao_kernel launches of reps calls of fn, the
    kernel's name), after one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and "ao_kernel<" in e.name and "bvh_ao_kernel" not in e.name]
    if len(ks) != reps:
        raise AssertionError(f"{len(ks)} ao_kernel launches for {reps} calls")
    us = sum(e.time_range.end - e.time_range.start for e in ks) / reps
    return us / 1e3, re.search(r"ao_kernel<[^>]*>", ks[0].name).group(0)


def main(argv) -> int:
    tree = Path(argv[0] if argv else Path(__file__).parent).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("profile_gather: no CUDA card visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.render.renderer import Renderer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    print(f"tree {tree}", flush=True)

    def renderer(state, tile):
        return Renderer(state.scene, tile_size=tile, device="cuda")

    shapes = (
        ("headline", renderer(cs.bundled_state(640, 480, 3, 64, sunsky=False),
                              cs.TILE), cs.ao_gather_inputs, 8, 8, True),
        ("heightfield91", renderer(cs.heightfield_state(91), 128),
         cs.ao_gather_inputs, 8, 8, True),
        ("whitted-2x2", renderer(cs.bundled_state(
            640, 480, 3, sunsky=False, method="whitted"), cs.TILE),
         cs.whitted_gather_inputs, 2, 2, False),
    )
    for label, r, make_inputs, nt, nph, both in shapes:
        P_off, b0, b1, b2, hit, jitter = make_inputs(r)
        nhit = int(hit.sum())
        for fn in (ao.ao_occlusion, ao.ao_occlusion_bits)[: 2 if both else 1]:
            ms, name = kernel_ms(lambda: fn(r.scene, P_off, b0, b1, b2, hit,
                                            jitter, nt, nph))
            print(f"[{label}] {fn.__name__}: {P_off.shape[0]} lanes, {nhit} "
                  f"hit, {nt}x{nph} strata: kernel {ms:.3f} ms ({name})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
