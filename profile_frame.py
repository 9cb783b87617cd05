#!/usr/bin/env python3
"""Where a frame's time goes on the card: one warm frame of a chip_smoke
scene under torch.profiler (CPU + CUDA activity).

    python3 profile_frame.py [--frames N] [cell ...]

Cells (default: all): headline-sunsky and headline-ao (the bundled scene
at 640x480, 3x3, 64 rays, tile 240, with and without its sunsky light),
heightfield91 (dense, 160x120, 2x2, 64 rays, tile 128), heightfield256,
heightfield256-sunsky and heightfield724 (the tile BVH, same frame); the
integrators: headline-whitted and headline-pathtrace (the bundled scene
without its sunsky line: the default dome), bundled-whitted-sunsky (as
shipped), heightfield256-whitted (the dome through the cone gather) and
heightfield256-whitted-fused; and the fused tile-BVH AO gather
(LUCILLE_BVH_AO=fused): heightfield256-ao-fused, heightfield724-ao-fused;
and the dense AO strata scan above 131,072 triangles: the n = 258
terrain on the dense tiles at 80x60, 2x2, 16 rays, tile 40,
heightfield258-scan and heightfield258-scan-sunsky; and the dirt map,
depth of field and textures: bundled-dirtmap (the headline settings
without the sunsky line, dense), heightfield256-dirtmap (tile BVH),
bundled-dof (the headline AO frame under chip_smoke.DOF_LINE) and
textured-ao (chip_smoke.textured_state's checker quad at 640x480, 3x3,
64 rays); and environment lighting and the shading pipeline:
bundled-ibl-whitted (the headline settings as Whitted under
chip_smoke's 2048x1024 lat-long sky, cosweight), heightfield256-ibl-
whitted (the n = 256 terrain's frame under the sky, importance) and
bundled-pipeline (headline-ao with miefog, the background imager and
MOSAICdisplace); and the shader method: bundled-shader-sl (the headline
settings, the scene as shipped, whitted.sl bound to every geometry),
bundled-shader-ao (the scene without its sunsky line, the built-in
ambientocclusion surface) and heightfield256-shader (the n = 256
terrain's frame, plastic under a distant light); and lucille_tpu's
other accels: headline-ao-grid and
heightfield256-grid (the headline AO and the n = 256 terrain's frames on
the uniform grid), headline-ao-bruteforce and headline-ao-mxu (the
headline AO frame under lucille_tpu's dense requests) and
heightfield256-rebinned (the terrain's frame under
LUCILLE_BVH_AO=rebinned); and fur (the fur example at its defaults:
400 Bezier strands, 25,602 triangles on the tile BVH, 320x240, 2x2, 64
rays, tile 128); and, asked for by name (not among the
default cells), inverse-render: the inverse-render example's forward
and backward pass at 640x480, 4 samples, depth 3.

Per cell it prints the warm frame's seconds without the profiler (best
of N, default 2, and every sample), the profiled frame's wall time
(host clock around render_frame and a synchronize), the device busy
time (the union of the device's kernel and copy intervals), the idle
share 1 - busy / wall, the
number of device operations, the host's waits on the card (the CUDA
runtime's synchronize calls the profiler saw: pulling a finished tile
back makes two, anything more is a wait inside the enqueue), and the
device time by operation name, largest first.  The profiler adds host
cost, so the profiled wall time is above the unprofiled frame's.  The
card's nvidia-smi name and power limit come first.  Needs one card;
imports nothing of lucille_tpu.  It imports the chip_smoke.py and the
package beside it, so a copy placed in another checkout's root profiles
that checkout.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict

import chip_smoke as cs

# cell -> (scene description, tile, LUCILLE_BVH_AO)
CELLS = {
    "headline-sunsky": (lambda: cs.bundled_state(640, 480, 3, 64), cs.TILE,
                        "cone"),
    "headline-ao": (lambda: cs.bundled_state(640, 480, 3, 64, sunsky=False),
                    cs.TILE, "cone"),
    "heightfield91": (lambda: cs.heightfield_state(91), 128, "cone"),
    "heightfield256": (lambda: cs.heightfield_state(256), 128, "cone"),
    "heightfield256-sunsky": (lambda: cs.heightfield_state(256, sunsky=True),
                              128, "cone"),
    "heightfield724": (lambda: cs.heightfield_state(724), 128, "cone"),
    "headline-whitted": (lambda: cs.bundled_state(
        640, 480, 3, sunsky=False, method="whitted"), cs.TILE, "cone"),
    "headline-pathtrace": (lambda: cs.bundled_state(
        640, 480, 3, sunsky=False, method="pathtrace"), cs.TILE, "cone"),
    "bundled-whitted-sunsky": (lambda: cs.bundled_state(
        640, 480, 3, method="whitted"), cs.TILE, "cone"),
    "heightfield256-whitted": (lambda: cs.heightfield_state(
        256, method="whitted"), 128, "cone"),
    "heightfield256-whitted-fused": (lambda: cs.heightfield_state(
        256, method="whitted"), 128, "fused"),
    "heightfield256-ao-fused": (lambda: cs.heightfield_state(256), 128,
                                "fused"),
    "heightfield724-ao-fused": (lambda: cs.heightfield_state(724), 128,
                                "fused"),
    "heightfield258-scan": (lambda: cs.heightfield_state(
        258, 80, 60, pixelsamples=2, gather=16, accel="pallas"), 40, "cone"),
    "heightfield258-scan-sunsky": (lambda: cs.heightfield_state(
        258, 80, 60, pixelsamples=2, gather=16, accel="pallas", sunsky=True),
        40, "cone"),
    "bundled-dirtmap": (lambda: cs.bundled_state(
        640, 480, 3, 64, sunsky=False, method="dirtmap"), cs.TILE, "cone"),
    "heightfield256-dirtmap": (lambda: cs.heightfield_state(
        256, method="dirtmap"), 128, "cone"),
    "bundled-dof": (lambda: cs.bundled_state(640, 480, 3, 64, sunsky=False,
                                             dof=True), cs.TILE, "cone"),
    "textured-ao": (lambda: cs.textured_state(640, 480), cs.TILE, "cone"),
    "bundled-ibl-whitted": (lambda: cs.ibl_bundled(640, 480, pixelsamples=3),
                            cs.TILE, "cone"),
    "heightfield256-ibl-whitted": (lambda: cs.heightfield_state(
        256, light=cs.ibl_line("importance"), method="whitted"), 128, "cone"),
    "bundled-pipeline": (lambda: cs.bundled_state(
        640, 480, 3, 64, sunsky=False, head=cs.PIPELINE_IMAGER,
        world=cs.pipeline_world()), cs.TILE, "cone"),
    "bundled-shader-sl": (cs.shader_sl_state, cs.TILE, "cone"),
    "bundled-shader-ao": (cs.shader_ao_state, cs.TILE, "cone"),
    "heightfield256-shader": (cs.shader_hf_state, 128, "cone"),
    "headline-ao-grid": (lambda: cs.bundled_state(
        640, 480, 3, 64, sunsky=False, accel="grid"), cs.TILE, "cone"),
    "heightfield256-grid": (lambda: cs.heightfield_state(256, accel="grid"),
                            128, "cone"),
    "headline-ao-bruteforce": (lambda: cs.bundled_state(
        640, 480, 3, 64, sunsky=False, accel="bruteforce"), cs.TILE, "cone"),
    "headline-ao-mxu": (lambda: cs.bundled_state(
        640, 480, 3, 64, sunsky=False, accel="mxu"), cs.TILE, "cone"),
    "heightfield256-rebinned": (lambda: cs.heightfield_state(256), 128,
                                "rebinned"),
    "fur": (lambda: fur_state(), 128, "cone"),
}


def fur_state():
    """The fur example's scene at its defaults (examples/fur.py)."""
    from lucille_tpu_torch.examples.fur import fur_state as state

    return state()


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def frame_profile(r, frames: int = 2) -> dict:
    """Renderer r's warm frame: its seconds without the profiler (best of
    `frames`, and every sample), then one frame under torch.profiler:
    wall_ms (host clock around render_frame and a synchronize), busy_ms
    (the union of the device's intervals), idle (1 - busy / wall), ops
    (device operations), syncs (the host's waits on the card), by_name
    {device op name: [ms, count]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    r.render_frame()  # warm-up: the kernel build, caches, allocator
    torch.cuda.synchronize()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in dev]) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    # the host's waits on the card: the runtime's synchronize calls
    syncs = sum(1 for e in events if e.device_type != DeviceType.CUDA
                and "Synchronize" in e.name)
    return {"times": times, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle": 1 - busy_ms / wall_ms, "ops": len(dev), "syncs": syncs,
            "by_name": dict(by_name)}


def profile(cell: str, frames: int = 2, top: int = 12) -> None:
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list

    make_state, tile, mode = CELLS[cell]
    r = Renderer(make_state().scene, tile_size=tile, device="cuda")
    with cs.bvh_ao_mode(mode):
        p = frame_profile(r, frames)
    opt = r.desc.options
    n_tiles = len(tile_list(opt.width, opt.height, tile, opt.bucket_order))
    times = p["times"]
    samples = ", ".join(f"{t * 1e3:.2f}" for t in times)
    print(f"[{cell}] frame {min(times) * 1e3:.2f} ms unprofiled (best of "
          f"{frames}: {samples}); profiled frame {p['wall_ms']:.2f} ms, "
          f"device busy {p['busy_ms']:.2f} ms, idle share {p['idle']:.3f}, "
          f"{p['ops']} device ops, {p['syncs']} host syncs ({n_tiles} "
          f"tiles; each tile's pull makes 2)", flush=True)
    for name, (ms, n) in sorted(p["by_name"].items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:100]}")


INVERSE = "inverse-render"  # not a frame: a forward and backward pass


def profile_inverse(frames: int = 2, top: int = 12) -> None:
    """The inverse-render example's step at 640x480, 4 samples, depth 3
    (chip_smoke phase 32's): the forward and the backward pass timed on
    the host clock around each and a synchronize (best of `frames`, every
    sample), then one step under torch.profiler: device busy, idle share,
    device ops, and the device time by operation name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from lucille_tpu_torch.examples.inverse_render import TRUE_KD, setup
    from lucille_tpu_torch.sampling.jitter import TileSampler

    render_fn, params = setup(640, 480, "cuda", spp=4, max_depth=3)
    dev = params["mat_kd"].device
    stream = TileSampler(0, dev)(0, 0)
    with torch.no_grad():
        target = render_fn({**params, "mat_kd": torch.tensor(
            TRUE_KD, device=dev)}, stream)

    def step():
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        t0 = time.perf_counter()
        loss = torch.mean((render_fn(leaves, stream) - target) ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    step()  # warm-up
    samples = [step() for _ in range(frames)]
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in dev_events]) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    fwd = ", ".join(f"{f * 1e3:.2f}" for f, _b in samples)
    bwd = ", ".join(f"{b * 1e3:.2f}" for _f, b in samples)
    print(f"[{INVERSE}] 640x480, 4 samples, depth 3: forward ms {fwd}; "
          f"backward ms {bwd}; profiled step {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(dev_events)} device ops", flush=True)
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:100]}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_frame: no CUDA card visible", file=sys.stderr)
        return 1
    frames = 2
    if argv[:1] == ["--frames"]:
        frames, argv = int(argv[1]), argv[2:]
    cells = argv or list(CELLS)
    unknown = [c for c in cells if c not in CELLS and c != INVERSE]
    if unknown:
        print(f"profile_frame: unknown cells {unknown}; know {list(CELLS)}",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    for cell in cells:
        if cell == INVERSE:
            profile_inverse(frames)
        else:
            profile(cell, frames)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
