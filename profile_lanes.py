#!/usr/bin/env python3
"""The grid walk's lanes a ray (`accel.ugrid.group_lanes`: 1 or 8)
measured on both sides of the rule's two thresholds, the grid's
resolution (GROUP_RES) and the rays a launch (GROUP_THREADS).

    python3 profile_lanes.py [config ...]

For each config, a Renderer on the grid accel and one profiled warm
frame at 1, 8, 8 and 1 lanes a ray in turn (the rule replaced here, in
this process only): the walk's device ms summed over the frame, the
closest hit's and the any-hits' (launches and ms a launch), the busy
ms and the best unprofiled frame (`profile_frame.frame_profile`).
Configs (default: all), each a grid and a tile of tile^2 x samples rays
a launch:
  bundled-t64, -t128, -t240: the bundled scene's 9^3 grid at 640x480,
    3x3, 64 AO rays, tile 64 (the Renderer's and the CLI's default),
    128 and 240 (the headline tile);
  hf35-t128 (17^3), hf91-t64, -t128, -t256 (32^3), hf256-t64, -t128,
    -t181, -t256, -t360 (64^3): bench_large's terrains at 2x2, 64 AO
    rays, 160x120, or an image of 2x2 tiles where the tile is larger.
The card's nvidia-smi name and power limit come first.  Needs one card;
imports nothing of lucille_tpu.
"""

from __future__ import annotations

import subprocess
import sys

import chip_smoke as cs


def _bundled():
    return cs.bundled_state(640, 480, 3, 64, sunsky=False, accel="grid")


def _terrain(n, side=None):
    if side is None:
        return lambda: cs.heightfield_state(n, accel="grid")
    return lambda: cs.heightfield_state(n, side, side, accel="grid")


# config -> (scene description, tile)
CONFIGS = {
    "bundled-t64": (_bundled, 64),
    "bundled-t128": (_bundled, 128),
    "bundled-t240": (_bundled, 240),
    "hf35-t128": (_terrain(35), 128),
    "hf91-t64": (_terrain(91), 64),
    "hf91-t128": (_terrain(91), 128),
    "hf91-t256": (_terrain(91, 512), 256),
    "hf256-t64": (_terrain(256), 64),
    "hf256-t128": (_terrain(256), 128),
    "hf256-t181": (_terrain(256, 362), 181),
    "hf256-t256": (_terrain(256, 512), 256),
    "hf256-t360": (_terrain(256, 720), 360),
}


def sweep(name: str) -> None:
    import torch

    from lucille_tpu_torch.accel import ugrid
    from lucille_tpu_torch.render.renderer import Renderer
    from profile_frame import frame_profile

    make_state, tile = CONFIGS[name]
    r = Renderer(make_state().scene, tile_size=tile, device="cuda")
    xs, ys = (int(v) for v in r.desc.options.current_display().sampling_rates)
    rays = tile * tile * xs * ys
    rule = ugrid.group_lanes
    try:
        for lanes in (1, 8, 8, 1):
            ugrid.group_lanes = lambda scene, B, lanes=lanes: lanes
            p = frame_profile(r, 3)
            walk = {}
            for kind, tag in (("closest", "grid_kernel<false"),
                              ("any", "grid_kernel<true")):
                hits = [v for k, v in p["by_name"].items() if tag in k]
                ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
                walk[kind] = (ms, n)
            (cms, cn), (ams, an) = walk["closest"], walk["any"]
            print(f"[{name}] grid {r.scene.grid_res}^3, {rays} rays a "
                  f"launch, {lanes} lanes a ray: closest {cms:.4f} ms / "
                  f"{cn} = {cms / max(cn, 1):.4f}; any {ams:.4f} ms / {an} "
                  f"= {ams / max(an, 1):.4f}; walk {cms + ams:.3f} ms; busy "
                  f"{p['busy_ms']:.2f} ms; frame best "
                  f"{min(p['times']) * 1e3:.2f} ms", flush=True)
    finally:
        ugrid.group_lanes = rule
    del r
    torch.cuda.empty_cache()


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_lanes: no CUDA card visible", file=sys.stderr)
        return 1
    names = argv or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        print(f"profile_lanes: unknown configs {unknown}; know "
              f"{list(CONFIGS)}", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    for name in names:
        sweep(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
