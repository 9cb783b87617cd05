#!/usr/bin/env python3
"""The gather kernels' device time at the shapes the main paths give
them, for comparing two trees in one call.

    python3 profile_gather.py [TREE] [SHAPE ...]

TREE is the root of a checkout of this repository (default: the
directory of this script).  Its lucille_tpu_torch and chip_smoke are
imported, and its kernels built, so `python3 profile_gather.py
_archive/parent` times an unpacked parent commit with the same shapes
and the same clock.  The shapes (default: all), each from TREE's
chip_smoke helpers:

the dense AO gather (csrc/ao.cu, kernels 3 and 3b), through
`accel.ao.ao_occlusion` / `ao_occlusion_bits`:
  headline: the bundled scene's first 240x240 tile at 3x3 samples
    (518,400 lanes; 322 triangles in 4 tiles), 8x8 strata, the counts
    and the counts with bits;
  heightfield91: the first 128x128x4 tile of the 16,200-triangle
    terrain (128 tiles), 8x8 strata, both outputs;
  whitted-2x2: headline-whitted's first-bounce dome gather on the
    bundled tile, 2x2 strata, the counts;
  each line also gives the gather's counters (box and triangle tests,
  set-ups, warp steps and SIMT efficiency; one more launch, with
  counters=True) where the tree's kernel counts;
the tile-BVH kernels (csrc/bvh.cu) on the first 128x128x4 tile of
bench_large's terrain at n = 256 (130,050 triangles) and n = 724
(1,045,458), through the public entry points:
  cone256, cone724: the cone-tiled gather at 8x8 strata
    (`accel.bvh_ao.bvh_ao_occlusion` under LUCILLE_BVH_AO=cone): kernel
    5 on 4,194,304 gather rays;
  fused256, fused724: the fused gather at 8x8 strata (the same call
    under LUCILLE_BVH_AO=fused): kernel 6;
  fused256-2x2: kernel 6 on the n = 256 Whitted frame's first-bounce
    dome gather, 2x2 strata;
  closest256, closest724: kernel 4 on the tile's 65,536 eye rays
    (`accel.dispatch.closest_hit`); closest256-bounce, closest724-bounce:
    the same with a bounce wavefront's active mask (half the rays live,
    chip_smoke.check_closest_active's); closest256-slice,
    closest724-slice: on 16,384 / 4,096 of them, centred on the hits
    (chip_smoke.check_bvh_kernels' slices);
the grid walk (csrc/ugrid.cu) on chip_smoke phase 29's shapes, the
closest hit on a tile's eye rays and the any-hit on stratum 7 of 64 of
the AO scan's gather rays from their hits, each through
`accel.dispatch`, as the render paths call it (the any-hit of a tree
that counts where nothing reads the counters sums them there too):
  grid-headline: the bundled scene's headline tile (518,400 rays, a 9^3
    grid);
  grid-hf256: the n = 256 terrain's first tile (65,536 rays, a 64^3
    grid);
the dense closest hit and any-hit (csrc/isect.cu, kernels 1 and 2),
through `accel.dispatch.closest_hit` / `any_hit`, the closest hit on a
tile's eye rays and the any-hit on its hit lanes' shadow rays toward a
sun:
  isect-headline: the bundled scene as shipped, its first 240x240 tile
    at 3x3 samples (518,400 eye rays; 322 triangles), toward its sun;
  isect-hf91: the first 128x128x4 tile of the 16,200-triangle terrain
    (65,536 rays, 128 tiles), toward the bundled scene's sun;
  isect-scan: the dense strata scan's frame (the n = 258 terrain,
    132,098 triangles in 1,033 tiles, 80x60, 2x2, tile 40): its first
    tile's 6,400 rays, toward a low sun (chip_smoke.check_split_kernels);
  isect-bounce: the headline tile's rays with a bounce wavefront's
    active mask (half the rays live, chip_smoke.check_closest_active's),
    the any-hit on the live hit lanes.

Each call runs REPS times under torch.profiler; the kernel time is the
mean device time of the CUDA events whose names hold the kernel's (the
names any tree of this repository has given it), summed over those
names (the dense kernels' split path adds a memset and, for the closest
hit, an epilogue).  Prints
the card's nvidia-smi name and power limit and one line per (shape,
output); the kernels' registers and spills are chip_smoke.py's to
print.  Needs one card; imports nothing of lucille_tpu.
"""

from __future__ import annotations

import inspect
import re
import subprocess
import sys
from pathlib import Path

REPS = 10
# kernel -> the substrings its CUDA event's name holds, in any tree
NAMES = {
    "ao_kernel": ("ao_kernel<",),
    "bvh_any_hit": ("bvh_kernel<true>", "bvh_any_kernel"),
    "bvh_ao_fused": ("bvh_ao_kernel",),
    "bvh_closest_hit": ("bvh_kernel<false>", "bvh_closest_kernel"),
    "closest_hit": ("closest_hit_kernel", "closest_epilogue", "Memset"),
    "any_hit": ("any_hit_kernel", "Memset"),
    "grid": ("grid_kernel<",),
    "sky_gather": ("sky_gather_kernel<",),
}


def kernel_ms(fn, kernel: str, reps: int = REPS) -> tuple[float, str]:
    """(device ms of `kernel` in a call of fn: the mean duration of each
    device event name that holds one of NAMES[kernel], summed over those
    names; the names), from reps calls under the profiler after one
    call.  The profiler now and then drops a few device events, so a
    name's mean is taken over the events it kept, and a window in which
    it kept none is profiled again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and any(n in e.name for n in NAMES[kernel])
                    and not (kernel == "ao_kernel"
                             and "bvh_ao_kernel" in e.name)):
                m = re.search(r"[A-Za-z_]+(<[^>]*>)?(?=\()", e.name)
                name = m.group(0) if m else e.name[:60]
                spans.setdefault(name, []).append(
                    e.time_range.end - e.time_range.start)
        if any(len(v) > reps for v in spans.values()):
            raise AssertionError(f"more {kernel} events than calls: "
                                 f"{ {k: len(v) for k, v in spans.items()} }")
        # the kernel proper (not only its memset) seen
        if any("Memset" not in k for k in spans):
            us = sum(sum(v) / len(v) for v in spans.values())
            return us / 1e3, " + ".join(spans)
    raise AssertionError(f"the profiler kept no {kernel} event in 3 tries")


def main(argv) -> int:
    tree = Path(argv[0] if argv else Path(__file__).parent).resolve()
    wanted = set(argv[1:])
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("profile_gather: no CUDA card visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lucille_tpu_torch.accel import ao, bvh_ao
    from lucille_tpu_torch.accel.dispatch import any_hit, closest_hit
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.transport.ao import shading_frame

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    print(f"tree {tree}", flush=True)

    renderers = {}

    def renderer(key, make_state, tile):
        if key not in renderers:
            renderers[key] = Renderer(make_state().scene, tile_size=tile,
                                      device="cuda")
        return renderers[key]

    def dense(label, make_state, tile, make_inputs, nt, nph, both):
        r = renderer(label, make_state, tile)
        P_off, b0, b1, b2, hit, jitter = make_inputs(r)
        nhit = int(hit.sum())
        # the kernel's counters, where the tree's kernel counts
        counts = "counters" in inspect.signature(
            ao.ao_occlusion_kernel).parameters
        if counts:
            order, nact = ao.compaction_order(
                r.scene.bbox_min, r.scene.bbox_max, P_off, b2, hit,
                r.scene.boxes.shape[1])
            rays = torch.cat([P_off, b0, b1, b2], dim=1)[order].T.contiguous()
        for fn in (ao.ao_occlusion, ao.ao_occlusion_bits)[: 2 if both else 1]:
            ms, name = kernel_ms(lambda: fn(r.scene, P_off, b0, b1, b2, hit,
                                            jitter, nt, nph), "ao_kernel")
            work = ""
            if counts:
                st = ao.ao_occlusion_kernel(
                    r.scene, rays, jitter, nact, nt, nph,
                    fn is ao.ao_occlusion_bits, counters=True)[1]
                st = {k: int(v) for k, v in st.items()}
                work = (f"; supertile / tile / quarter / group box tests "
                        f"{st.get('super_tests', 0)} / {st['tile_tests']} / "
                        f"{st.get('quarter_tests', 0)} / "
                        f"{st['group_tests']}, set-ups {st['setups']}, "
                        f"tests {st['tests']}, warp steps "
                        f"{st['warp_steps']} (SIMT efficiency "
                        f"{st['tests'] / max(32 * st['warp_steps'], 1):.3f})")
            print(f"[{label}] {fn.__name__}: {P_off.shape[0]} lanes, {nhit} "
                  f"hit, {nt}x{nph} strata: kernel {ms:.3f} ms ({name})"
                  f"{work}", flush=True)

    def bvh_gather(label, n, method, make_inputs, nt, nph, mode):
        r = renderer(f"hf{n}-{method}", lambda: cs.heightfield_state(
            n, method=method), 128)
        P_off, b0, b1, b2, hit, jitter = make_inputs(r)
        kernel = "bvh_ao_fused" if mode == "fused" else "bvh_any_hit"
        with cs.bvh_ao_mode(mode):
            ms, name = kernel_ms(lambda: bvh_ao.bvh_ao_occlusion(
                r.scene, P_off, b0, b1, b2, hit, jitter, nt, nph), kernel)
        print(f"[{label}] {kernel}: {P_off.shape[0]} lanes, "
              f"{int(hit.sum())} hit, {nt}x{nph} strata, {mode} gather: "
              f"kernel {ms:.3f} ms ({name})", flush=True)

    def closest(label, n, half_live=False, n_slice=None):
        r = renderer(f"hf{n}-None", lambda: cs.heightfield_state(n), 128)
        org, dirn, _x0, _y0 = cs.first_tile_rays(r)
        B = org.shape[0]
        active = None
        if half_live:
            gen = torch.Generator(device="cuda").manual_seed(5)
            active = torch.rand(B, device="cuda", generator=gen) < 0.5
        if n_slice is not None:
            hits = torch.nonzero(closest_hit(r.scene, org, dirn)["hit"])[:, 0]
            mid = int(hits[len(hits) // 2]) if len(hits) else B // 2
            lo = min(max(0, mid - n_slice // 2), max(0, B - n_slice))
            org, dirn = org[lo:lo + n_slice], dirn[lo:lo + n_slice]
        ms, name = kernel_ms(lambda: closest_hit(r.scene, org, dirn,
                                                 active=active),
                             "bvh_closest_hit")
        live = "" if active is None else f", {int(active.sum())} live"
        print(f"[{label}] bvh_closest_hit: {org.shape[0]} eye rays{live}: "
              f"kernel {ms:.3f} ms ({name})", flush=True)

    def isect(label, make_state, tile, sun=None, half_live=False):
        r = renderer(label, make_state, tile)
        org, dirn, _x0, _y0 = cs.first_tile_rays(r)
        B = org.shape[0]
        active = None
        if half_live:
            gen = torch.Generator(device="cuda").manual_seed(5)
            active = torch.rand(B, device="cuda", generator=gen) < 0.5
        ms, name = kernel_ms(lambda: closest_hit(r.scene, org, dirn,
                                                 active=active), "closest_hit")
        print(f"[{label}] closest_hit: {B} eye rays"
              f"{'' if active is None else f', {int(active.sum())} live'}: "
              f"kernel {ms:.3f} ms ({name})", flush=True)
        res = closest_hit(r.scene, org, dirn, active=active)
        hit = res["hit"]
        P_off = shading_frame(r.scene, org, dirn, res)[0]
        if sun is None:
            sun = next(li for li in r.lights if li.type == "sun").direction
        wi = torch.nn.functional.normalize(
            torch.tensor(sun, dtype=torch.float32, device="cuda"), dim=0)
        wi = wi.expand(B, 3).contiguous()
        ms, name = kernel_ms(lambda: any_hit(r.scene, P_off, wi, None, hit),
                             "any_hit")
        print(f"[{label}] any_hit: {int(hit.sum())} live shadow rays of {B}: "
              f"kernel {ms:.3f} ms ({name})", flush=True)

    def grid(label, make_state, tile):
        from lucille_tpu_torch.accel import ugrid
        from lucille_tpu_torch.accel.gather import scan_dirs

        r = renderer(label, make_state, tile)
        org, dirn, x0, y0 = cs.first_tile_rays(r)
        B = org.shape[0]
        got = ugrid.grid_walk_kernel(r.scene, org, dirn)
        hit = got["tri"] >= 0
        P_off, b0, b1, b2 = shading_frame(r.scene, org, dirn,
                                          {**got, "hit": hit})
        wdir = scan_dirs(b0, b1, b2, r.sampler(x0, y0).uniform((7,), (B, 2)),
                         7, 8, 8)
        for name, fn, live in (
                ("closest_hit", lambda: closest_hit(r.scene, org, dirn), B),
                ("any_hit", lambda: any_hit(r.scene, P_off, wdir,
                                            active=hit), int(hit.sum()))):
            ms, kname = kernel_ms(fn, "grid")
            call_ms = cs.cuda_ms(fn, REPS)
            print(f"[{label}] grid {name}: {B} rays, {live} live: kernel "
                  f"{ms:.4f} ms ({kname}); a call {call_ms:.4f} ms (CUDA "
                  f"events, {REPS} calls)", flush=True)
        # the warps' own steps, where the tree's kernel counts them
        for name, res, live in (
                ("closest_hit", ugrid.grid_walk_kernel(r.scene, org, dirn),
                 B),
                ("any_hit", ugrid.grid_walk_kernel(r.scene, P_off, wdir, None,
                                                   hit, any_hit=True),
                 int(hit.sum()))):
            if "warp_ntrav" in res:
                lanes = ugrid.group_lanes(r.scene, B)
                trav, tests = int(res["ntrav"]), int(res["ntests"])
                w_trav = max(int(res["warp_ntrav"]), 1)
                w_tests = max(int(res["warp_ntests"]), 1)
                print(f"[{label}] grid {name}: {lanes} lanes a ray, ntrav "
                      f"{trav}, ntests {tests}, warp steps {w_trav} advance "
                      f"/ {w_tests} chunk, SIMT efficiency "
                      f"{lanes * trav / (32 * w_trav):.3f} / "
                      f"{tests / (32 * ugrid.K * w_tests):.3f}", flush=True)

    bundled = lambda **kw: cs.bundled_state(  # noqa: E731
        640, 480, 3, sunsky=False, **kw)
    shapes = {
        "headline": lambda: dense(
            "headline", lambda: bundled(gather=64), cs.TILE,
            cs.ao_gather_inputs, 8, 8, True),
        "heightfield91": lambda: dense(
            "heightfield91", lambda: cs.heightfield_state(91), 128,
            cs.ao_gather_inputs, 8, 8, True),
        "whitted-2x2": lambda: dense(
            "whitted-2x2", lambda: bundled(method="whitted"), cs.TILE,
            cs.whitted_gather_inputs, 2, 2, False),
        "cone256": lambda: bvh_gather("cone256", 256, None,
                                      cs.ao_gather_inputs, 8, 8, "cone"),
        "cone724": lambda: bvh_gather("cone724", 724, None,
                                      cs.ao_gather_inputs, 8, 8, "cone"),
        "fused256": lambda: bvh_gather("fused256", 256, None,
                                       cs.ao_gather_inputs, 8, 8, "fused"),
        "fused724": lambda: bvh_gather("fused724", 724, None,
                                       cs.ao_gather_inputs, 8, 8, "fused"),
        "fused256-2x2": lambda: bvh_gather(
            "fused256-2x2", 256, "whitted", cs.whitted_gather_inputs, 2, 2,
            "fused"),
        "closest256": lambda: closest("closest256", 256),
        "closest724": lambda: closest("closest724", 724),
        "closest256-bounce": lambda: closest("closest256-bounce", 256,
                                             half_live=True),
        "closest724-bounce": lambda: closest("closest724-bounce", 724,
                                             half_live=True),
        "closest256-slice": lambda: closest("closest256-slice", 256,
                                            n_slice=16384),
        "closest724-slice": lambda: closest("closest724-slice", 724,
                                            n_slice=4096),
        "grid-headline": lambda: grid(
            "grid-headline", lambda: bundled(gather=64, accel="grid"),
            cs.TILE),
        "grid-hf256": lambda: grid(
            "grid-hf256", lambda: cs.heightfield_state(256, accel="grid"),
            128),
        "isect-headline": lambda: isect(
            "isect-headline", lambda: cs.bundled_state(640, 480, 3, 64),
            cs.TILE),
        "isect-hf91": lambda: isect(
            "isect-hf91", lambda: cs.heightfield_state(91, sunsky=True), 128),
        "isect-scan": lambda: isect(
            "isect-scan", lambda: cs.heightfield_state(
                258, 80, 60, pixelsamples=2, gather=16, accel="pallas"), 40,
            sun=(1.0, 0.35, 0.2)),
        "isect-bounce": lambda: isect(
            "isect-bounce", lambda: cs.bundled_state(640, 480, 3, 64), cs.TILE,
            half_live=True),
    }
    unknown = wanted - set(shapes)
    if unknown:
        print(f"profile_gather: unknown shapes {sorted(unknown)}; know "
              f"{list(shapes)}", file=sys.stderr)
        return 2
    for label, run in shapes.items():
        if not wanted or label in wanted:
            run()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
