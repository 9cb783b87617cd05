#!/usr/bin/env python3
"""Smoke run of lucille_tpu_torch on one CUDA card: the quickest proof that
the port builds, is right and renders its main path on the GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from lucille_tpu_torch/csrc with nvcc (seconds,
   and ptxas's register report);
3. each kernel against its plain torch twin at the main path's shapes:
   the bundled AO scene's first 240x240 tile at 3x3 samples (518,400 eye
   rays; 322 triangles in 4 tiles) and one 128x128x4 tile of the
   16,200-triangle heightfield (128 tiles, 8 supertiles, Morton lane
   order).  The kernels run the whole tile; the twins are compared on a
   slice of lanes, each lane with the AO jitter the whole tile gives it.
   Tolerances: hit/tri equal on all but 1e-4 of the lanes, t/u/v within
   1e-6 relative; occlusion counts equal on all but 1e-4 of the lanes
   and within 1 there;
4. the headline frame (what bench.py times for lucille_tpu): the bundled
   scene at 640x480, 3x3 samples, 64 AO rays, tile 240, rendered by the
   port's Renderer on the card into an .hdr through lucille_tpu's display
   driver and read back: finite, mean in (0, 1), both kernels launched,
   no plain twin called; the warm frame seconds (best of 2) and Mrays/s;
   then the same renderer at 80x60 against CPU-lucille's own frame
   (tests/golden/ao_80x60_ref.hdr), held to tests/test_render.py's bound;
5. the dense path's upper range: the heightfield at 160x120, 2x2, 64 rays,
   with the same checks and timing;
6. the tile-BVH kernels against their plain twins on the first 128x128x4
   tile of bench_large's heightfield at n = 256 (130,050 triangles) and
   n = 724 (1,045,458): the closest hit on the tile's eye rays, the
   any-hit on its 8x8-strata gather rays with the sampler's jitter.  The
   kernels run the whole tile; the twins (brute force over every
   triangle) a slice of rays.  Tolerances: hit masks equal on all but
   1e-4 of the rays, triangle ids on all but 1e-3 (exact ties in t
   across leaves), t/u/v within 1e-6 relative; occlusion equal on all
   but 1e-4 of the rays;
7. the large-scene frames: both heightfields at bench_large's
   configuration, uncut (160x120, 2x2 samples, 64 AO rays, tile 128),
   with the checks of phase 4 (both BVH kernels launched, no dense
   kernel, no twin), the warm frame seconds and Mrays/s, and the host's
   scene, compile and tile-BVH build seconds;
8. the heightfield at n = 91 rendered on the dense tiles and on the tile
   BVH: the two draw their jitter differently (compacted slot against
   raster lane), so only the means over hit pixels are held, within 0.01;
9. a JSON line of per-kernel results, the card's line, and last
   {"ok": true, "device": {...}}.

It needs no jax, one card, and the repository around it: run from a
directory holding only this file, it fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# rendered frames, beside the kernel build (both gitignored)
OUT = ROOT / "lucille_tpu_torch" / "_build" / "smoke"
TILE = 240
# kernel name -> (source, the TPU kernel it replaces)
SOURCES = {
    "closest_hit": ("lucille_tpu_torch/csrc/isect.cu",
                    "lucille_tpu/accel/pallas_isect.py:57"),
    "ao_occlusion": ("lucille_tpu_torch/csrc/ao.cu",
                     "lucille_tpu/accel/pallas_ao.py:109"),
    "bvh_closest_hit": ("lucille_tpu_torch/csrc/bvh.cu",
                        "lucille_tpu/accel/pallas_bvh.py:310"),
    "bvh_any_hit": ("lucille_tpu_torch/csrc/bvh.cu",
                    "lucille_tpu/accel/pallas_bvh.py:598"),
}


def bundled_state(width, height, pixelsamples=None, gather=None):
    """tests/golden/sunsky_scene.rib without its sunsky light: the
    reference's ambient_occlusion.rib (322 triangles), parsed in memory."""
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib

    rib = ROOT / "tests" / "golden" / "sunsky_scene.rib"
    text = "".join(l for l in rib.read_text().splitlines(keepends=True)
                   if 'AreaLightSource "sunsky"' not in l)
    s = RiState()
    parse_rib(text, s)
    s.Format(width, height)
    if pixelsamples is not None:
        s.PixelSamples(pixelsamples, pixelsamples)
    if gather is not None:
        s.options.gather_nsamples = gather
    return s


def heightfield_state(n, width, height, pixelsamples, gather, accel="auto"):
    from bench_large import heightfield_scene

    s = heightfield_scene(n)
    s.Format(width, height)
    s.PixelSamples(pixelsamples, pixelsamples)
    s.options.gather_nsamples = gather
    s.options.accel_method = accel
    return s


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from lucille_tpu_torch.accel import ao, bvh_isect, isect

    return {"closest_hit": isect.COUNTS, "ao_occlusion": ao.COUNTS,
            "bvh_closest_hit": bvh_isect.CLOSEST_COUNTS,
            "bvh_any_hit": bvh_isect.ANY_COUNTS}


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over reps runs, after one."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), milliseconds of that one run on the card)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_kernels(label, desc, tile, n_slice, results):
    """Phase 3 for one scene: both kernels on the scene's first tile
    against their plain twins.  Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import ao, isect
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.accel.pack import (
        pack_boxes,
        pack_occ,
        pack_super_boxes,
        pack_tris,
    )
    from lucille_tpu_torch.render.renderer import Renderer, tile_eye_rays
    from lucille_tpu_torch.render.tiles import tile_list
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples
    from lucille_tpu_torch.transport.ao import shading_frame

    r = Renderer(desc, tile_size=tile, device="cuda")
    scene = r.scene
    opt = desc.options
    xs, ys = (int(v) for v in opt.current_display().sampling_rates)
    sub = torch.tensor(subpixel_samples(xs, ys)[0], dtype=torch.float32,
                       device="cuda")
    x0, y0, _i, _j = tile_list(opt.width, opt.height, tile,
                               opt.bucket_order)[0]
    org, dirn = tile_eye_rays(r.camera, x0, y0, tile, tile, sub)
    B = org.shape[0]
    lo = max(0, B // 2 - n_slice // 2)
    sl = slice(lo, lo + n_slice)
    n_tiles = scene.n_pad // 128
    print(f"[{label}] {scene.n_tris} triangles, {n_tiles} tiles, tile "
          f"({x0},{y0}) {tile}x{tile}x{xs * ys} = {B} eye rays, "
          f"slice {n_slice}", flush=True)

    # -- kernel 1: closest hit
    tris, boxes = pack_tris(scene), pack_boxes(scene)
    got = isect.closest_hit_kernel(tris, boxes, org, dirn)
    ref = isect.closest_hit_reference(tris, org[sl], dirn[sl])
    torch.cuda.synchronize()
    tri_k, tri_r = got["tri"][sl], ref["tri"]
    differ = (tri_k != tri_r).float().mean().item()
    same = (tri_k == tri_r) & (tri_r >= 0)
    err = 0.0
    for k in ("t", "u", "v"):
        a, b = got[k][sl][same], ref[k][same]
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        err = max(err, (a - b).abs().max().item())
    if differ > 1e-4:
        raise AssertionError(f"closest_hit: {differ:.2e} of lanes differ")
    ms = cuda_ms(lambda: isect.closest_hit_kernel(tris, boxes, org, dirn), 10)
    plain_ms = cuda_ms(lambda: isect.closest_hit_reference(tris, org, dirn), 1)
    hit_rate = (got["tri"] >= 0).float().mean().item()
    print(f"[{label}] closest_hit: hit rate {hit_rate:.4f}, tri differs on "
          f"{differ:.2e} of the slice, max |t,u,v err| {err:.3e}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    results["closest_hit"].append(
        {"scene": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # -- kernel 2: AO gather, 8x8 strata, the jitter of the whole tile
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    jitter = r.sampler(x0, y0, B)
    occ = ao.ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter, 8, 8)
    order, nhit = ao.compaction_order(scene.bbox_min, scene.bbox_max, P_off,
                                      b2, hit, n_tiles)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(B, device="cuda")
    lanes = torch.arange(B, device="cuda")[sl]
    lanes = lanes[hit[lanes]]
    frame = torch.cat([P_off, b0, b1, b2], dim=1)
    tris_o = pack_occ(scene)
    ref_occ = ao.ao_occlusion_reference(
        tris_o, frame[lanes].T.contiguous(), jitter[:, slot[lanes]], 8, 8,
        lane_chunk=65536)
    torch.cuda.synchronize()
    diff = (occ[lanes] - ref_occ).abs()
    frac = (diff != 0).float().mean().item()
    if diff.max().item() > 1 or frac > 1e-4:
        raise AssertionError(f"ao_occlusion: {frac:.2e} of lanes differ, "
                             f"max {diff.max().item()}")
    if torch.any(occ[sl][~hit[sl]] != 0):
        raise AssertionError("ao_occlusion: a missed lane has occlusion")
    rays = frame[order].T.contiguous()
    sboxes = pack_super_boxes(boxes)
    ms = cuda_ms(lambda: ao.ao_occlusion_kernel(
        tris_o, boxes, sboxes, rays, jitter, nhit, 8, 8), 5)
    n = int(nhit)
    plain_ms = cuda_ms(lambda: ao.ao_occlusion_reference(
        tris_o, rays[:, :n], jitter[:, :n], 8, 8, lane_chunk=65536), 1)
    print(f"[{label}] ao_occlusion: {n} hit lanes, mean occluded "
          f"{occ[hit].mean().item():.3f}/64, {len(lanes)} compared, "
          f"{frac:.2e} differ; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms",
          flush=True)
    results["ao_occlusion"].append(
        {"scene": label, "max_abs_err": diff.max().item(), "ms": ms,
         "plain_ms": plain_ms})


def render_checked(label, r, out_name, path):
    """Phases 4, 5 and 7 on Renderer r: warm-up, then one counted frame
    through the display driver into an .hdr that is read back and
    checked, then best of 2.  `path` names the kernels the frame must
    launch; every other kernel must launch none, and no twin may run.
    Returns the counted frame's launches of the path's kernels."""
    import numpy as np
    import torch

    from lucille_tpu.display.drivers import get_display_driver
    from lucille_tpu.imageio.rgbe import read_hdr

    r.render_frame()  # warm-up
    torch.cuda.synchronize()
    counts = counters()
    for c in counts.values():
        c.reset()
    OUT.mkdir(parents=True, exist_ok=True)
    path_file = OUT / out_name
    drv = get_display_driver("file")
    opt = r.desc.options
    drv.open(str(path_file), opt.width, opt.height)
    r.render_frame(tile_cb=drv.write)
    drv.close()
    launches = {k: c.kernel for k, c in counts.items()}
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"{label}: a kernel was not launched: {launches}")
    if any(launches[k] for k in counts if k not in path):
        raise AssertionError(f"{label}: a kernel off the path ran: {launches}")
    if any(c.plain for c in counts.values()):
        raise AssertionError(f"{label}: a plain twin ran on the card")
    img = read_hdr(path_file)
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: bad image {img.shape}")
    mean = float(img.mean())
    if not 0.0 < mean < 1.0:
        raise AssertionError(f"{label}: image mean {mean}")
    times, nrays = [], 0
    for _ in range(2):
        r.stats.nrays = 0
        r.stats.render_seconds = 0.0
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        nrays = r.stats.nrays
    best = min(times)
    launches = {k: launches[k] for k in path}
    print(f"[{label}] {opt.width}x{opt.height}, "
          f"{int(opt.current_display().sampling_rates[0])}^2 samples, "
          f"{opt.gather_nsamples} AO rays, tile {r.tile_size}, accel "
          f"{r.scene.accel}: image mean {mean:.4f}, launches {launches}; "
          f"frame {best:.4f} s (samples {[round(t, 4) for t in times]}), "
          f"{nrays} rays, {nrays / best / 1e6:.1f} Mrays/s", flush=True)
    return launches


def build_renderer(label, make_state, tile):
    """A Renderer on the card, with the host's seconds for the scene
    description, the compile, and the tile-BVH build inside it."""
    from lucille_tpu.base.timer import get_timer
    from lucille_tpu_torch.render.renderer import Renderer

    t0 = time.perf_counter()
    desc = make_state().scene
    t1 = time.perf_counter()
    bvh0 = get_timer().elapsed("BVH Construction")
    r = Renderer(desc, tile_size=tile, device="cuda")
    t2 = time.perf_counter()
    bvh = get_timer().elapsed("BVH Construction") - bvh0
    sc = r.scene
    print(f"[{label}] host: scene description {t1 - t0:.3f} s, compile "
          f"{t2 - t1:.3f} s (tile BVH build {bvh:.3f} s); {sc.n_tris} "
          f"triangles in {sc.n_pad} slots, accel {sc.accel}, {sc.n_nodes} "
          f"nodes, depth {sc.tree_depth}, {sc.leaf_tiles_max} tiles per "
          f"leaf at most", flush=True)
    return r


def check_bvh_kernels(label, r, n_closest, n_any, results):
    """Phase 6 for one scene: both tile-BVH kernels on the scene's first
    tile against their plain twins.  Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.bvh_ao import conetile_rays
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.accel.pack import pack_tris
    from lucille_tpu_torch.render.renderer import tile_eye_rays
    from lucille_tpu_torch.render.tiles import tile_list
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples
    from lucille_tpu_torch.transport.ao import shading_frame

    scene, opt, tile = r.scene, r.desc.options, r.tile_size
    xs, ys = (int(v) for v in opt.current_display().sampling_rates)
    sub = torch.tensor(subpixel_samples(xs, ys)[0], dtype=torch.float32,
                       device="cuda")
    x0, y0, _i, _j = tile_list(opt.width, opt.height, tile,
                               opt.bucket_order)[0]
    org, dirn = tile_eye_rays(r.camera, x0, y0, tile, tile, sub)
    B = org.shape[0]
    tris, nodes, depth = pack_tris(scene), scene.nodes, scene.tree_depth
    inf = lambda n: torch.full((n,), float("inf"), device="cuda")  # noqa: E731

    # -- tile-BVH closest hit on the eye rays
    got = bvh_isect.bvh_closest_hit(tris, nodes, org, dirn, depth=depth)
    hits = torch.nonzero(got["tri"] >= 0)[:, 0]  # centre the slice on them
    mid = int(hits[len(hits) // 2]) if len(hits) else B // 2
    lo = min(max(0, mid - n_closest // 2), max(0, B - n_closest))
    sl = slice(lo, lo + n_closest)
    ref, plain_ms = timed(lambda: bvh_isect.bvh_closest_hit_reference(
        tris, org[sl], dirn[sl], inf(n_closest)))
    tri_k, tri_r = got["tri"][sl], ref["tri"]
    hit_differ = ((tri_k >= 0) != (tri_r >= 0)).float().mean().item()
    differ = (tri_k != tri_r).float().mean().item()
    same = (tri_k == tri_r) & (tri_r >= 0)
    err = 0.0
    for k in ("t", "u", "v"):
        a, b = got[k][sl][same], ref[k][same]
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        err = max([err, *(a - b).abs().tolist()])
    if not same.any():
        raise AssertionError(f"{label} bvh_closest_hit: no hit in the slice")
    if hit_differ > 1e-4 or differ > 1e-3:
        raise AssertionError(f"{label} bvh_closest_hit: hit differs on "
                             f"{hit_differ:.2e}, tri on {differ:.2e}")
    ms = cuda_ms(lambda: bvh_isect.bvh_closest_hit(tris, nodes, org, dirn,
                                                   depth=depth), 5)
    ms_slice = cuda_ms(lambda: bvh_isect.bvh_closest_hit(
        tris, nodes, org[sl], dirn[sl], depth=depth), 5)
    hit_rate = (got["tri"] >= 0).float().mean().item()
    print(f"[{label}] bvh_closest_hit: {B} eye rays, hit rate "
          f"{hit_rate:.4f}, {int(got['ntrav'])} node visits, "
          f"{int(got['ntests'])} triangle tests; on {n_closest} rays tri "
          f"differs on {differ:.2e}, max |t,u,v err| {err:.3e}; kernel "
          f"{ms:.3f} ms ({ms_slice:.3f} ms on the slice), plain "
          f"{plain_ms:.3f} ms on the slice", flush=True)
    results["bvh_closest_hit"].append(
        {"scene": label, "rays": B, "ms": ms, "slice": n_closest,
         "ms_slice": ms_slice, "plain_ms": plain_ms, "max_abs_err": err,
         "tri_differs": differ})

    # -- tile-BVH any-hit on the tile's gather rays, 8x8 strata
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    jitter = r.sampler(x0, y0, B)
    oo, dd, _order, _layout = conetile_rays(scene, P_off, b0, b1, b2, hit,
                                            jitter, 8, 8)
    R = oo.shape[0]
    got = bvh_isect.bvh_any_hit(tris, nodes, oo, dd, depth=depth)
    live = int(hit.sum()) * 64  # the live gather rays lead the layout
    lo = max(0, live // 2 - n_any // 2)
    sl = slice(lo, lo + n_any)
    ref, plain_ms = timed(lambda: bvh_isect.bvh_any_hit_reference(
        tris, oo[sl], dd[sl], inf(n_any)))
    frac = (got["occ"][sl] != ref["occ"]).float().mean().item()
    if frac > 1e-4:
        raise AssertionError(f"{label} bvh_any_hit: {frac:.2e} of rays differ")
    ms = cuda_ms(lambda: bvh_isect.bvh_any_hit(tris, nodes, oo, dd,
                                               depth=depth), 3)
    ms_slice = cuda_ms(lambda: bvh_isect.bvh_any_hit(
        tris, nodes, oo[sl], dd[sl], depth=depth), 5)
    print(f"[{label}] bvh_any_hit: {R} gather rays ({live} live), occluded "
          f"{got['occ'][:live].float().mean().item():.4f}, "
          f"{int(got['ntrav'])} node visits, {int(got['ntests'])} triangle "
          f"tests; on {n_any} rays {frac:.2e} differ; kernel {ms:.3f} ms "
          f"({ms_slice:.3f} ms on the slice), plain {plain_ms:.3f} ms on "
          f"the slice", flush=True)
    results["bvh_any_hit"].append(
        {"scene": label, "rays": R, "ms": ms, "slice": n_any,
         "ms_slice": ms_slice, "plain_ms": plain_ms,
         "max_abs_err": float(frac > 0), "differs": frac})


def cross_check_accels():
    """Phase 8: the n = 91 heightfield on the dense tiles and on the tile
    BVH; means over the pixels both render as hits, within 0.01."""
    import numpy as np

    from lucille_tpu_torch.render.renderer import Renderer

    imgs = {}
    for accel in ("pallas", "bvh"):
        r = Renderer(heightfield_state(91, 160, 120, 2, 64, accel).scene,
                     tile_size=128, device="cuda")
        imgs[r.scene.accel] = r.render_frame()
    dense, bvh = imgs["dense"], imgs["pbvh"]
    lit = (dense[..., 0] > 0) & (bvh[..., 0] > 0)
    gap = abs(float(dense[lit].mean()) - float(bvh[lit].mean()))
    print(f"[cross-check] heightfield91 dense vs tile BVH: means over "
          f"{lit.mean():.4f} of the pixels {dense[lit].mean():.5f} and "
          f"{bvh[lit].mean():.5f}, gap {gap:.5f} (< 0.01)", flush=True)
    if not (lit.mean() > 0.2 and gap < 0.01):
        raise AssertionError("the dense and tile-BVH frames disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lucille_tpu_torch.kernels import build

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f}"
          f" s) -> {lib.path.relative_to(ROOT)}", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())

    # 3. kernels against their plain twins at the main path's shapes
    results = {"closest_hit": [], "ao_occlusion": []}
    check_kernels("bundled", bundled_state(640, 480, 3, 64).scene, TILE,
                  65536, results)
    check_kernels("heightfield91",
                  heightfield_state(91, 160, 120, 2, 64).scene, 128, 32768,
                  results)

    # 4. the headline frame, and the golden check at 80x60
    from lucille_tpu_torch.render.renderer import Renderer

    dense = ("closest_hit", "ao_occlusion")
    launches = render_checked(
        "headline", Renderer(bundled_state(640, 480, 3, 64).scene,
                             tile_size=TILE, device="cuda"),
        "chip_smoke_ao_640x480.hdr", dense)
    import numpy as np

    from lucille_tpu.imageio.rgbe import read_hdr

    golden = read_hdr(ROOT / "tests" / "golden" / "ao_80x60_ref.hdr")
    img = Renderer(bundled_state(80, 60).scene, tile_size=32,
                   device="cuda").render_frame()
    diff = np.abs(golden - img[::-1]).mean(axis=-1)
    print(f"[golden] 80x60 against CPU-lucille: mean |diff| "
          f"{diff.mean():.5f} (< 0.01), pixels > 0.1: "
          f"{(diff > 0.1).mean():.5f} (< 0.005)", flush=True)
    if not (diff.mean() < 0.01 and (diff > 0.1).mean() < 0.005):
        raise AssertionError("the port's frame disagrees with CPU-lucille's")

    # 5. the dense path's upper range
    render_checked("heightfield91", Renderer(
        heightfield_state(91, 160, 120, 2, 64).scene, tile_size=128,
        device="cuda"), "chip_smoke_heightfield91.hdr", dense)

    # 6. and 7. the tile-BVH kernels, then the large-scene frames
    bvh = ("bvh_closest_hit", "bvh_any_hit")
    results.update({k: [] for k in bvh})
    for n, n_closest, n_any in ((256, 16384, 32768), (724, 4096, 8192)):
        label = f"heightfield{n}"
        r = build_renderer(label, lambda: heightfield_state(n, 160, 120, 2,
                                                            64), 128)
        if r.scene.accel != "pbvh":
            raise AssertionError(f"{label}: accel {r.scene.accel}")
        check_bvh_kernels(label, r, n_closest, n_any, results)
        got = render_checked(label, r, f"chip_smoke_{label}.hdr", bvh)
        if n == 256:
            launches.update(got)
        for k in bvh:
            results[k][-1]["frame_launches"] = got[k]

    # 8. two accels, one scene
    cross_check_accels()

    # 9. results
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        head = results[name][0]  # the headline / heightfield256 tile
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in results[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "by_scene": results[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
