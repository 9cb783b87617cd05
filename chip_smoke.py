#!/usr/bin/env python3
"""Smoke run of lucille_tpu_torch on one CUDA card: the quickest proof that
the port builds, is right and renders its main paths on the GPU.

    python3 chip_smoke.py

Every scene is parsed from RIB text by the port's own front end
(lucille_tpu_torch.rib / .ri); the script imports nothing of lucille_tpu
and needs no jax.  Phases (each raises on failure, so the exit code is
non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from lucille_tpu_torch/csrc with nvcc (seconds,
   and ptxas's register report);
3. each dense kernel against its plain torch twin at the main paths'
   shapes: the bundled scene's first 240x240 tile at 3x3 samples (518,400
   eye rays; 322 triangles in 4 tiles) and one 128x128x4 tile of the
   16,200-triangle heightfield (128 tiles, 8 supertiles, Morton lane
   order).  The kernels run the whole tile; the twins are compared on a
   slice of lanes, each lane with the AO jitter the whole tile gives it.
   The closest hit on the eye rays; the AO gather's counts and its
   per-stratum bits at 8x8 strata; the any-hit on the hit lanes' shadow
   rays toward the scene's sun (the sunsky gather's sun ray), on the
   bundled tile also with a random finite tmax, on the heightfield with
   the hit mask as the active mask.  Both dense kernels print their lane
   triangle tests, group visits and warp steps (SIMT efficiency) against
   the need (`dense_need`: the real triangles of the 8-triangle groups,
   and of the tiles, each ray reaches before its hit or tmax; their bound
   also charges a box test for each real supertile, and for each real
   tile or group under a box the ray reaches), and on the
   bundled tile they answer unchanged when every pad slot past its 322
   triangles holds a triangle each ray would meet (`poisoned`): no pad
   slot is tested.  The AO gather prints its box and triangle tests,
   set-ups and warp steps (SIMT efficiency) against `gather_need`
   (`gather_work`), and answers unchanged, counts and bits, when the pad
   slots of its pack hold a box around the scene (`occ_poisoned`).  Then
   the gather's counts at 2x2 strata on the inputs of headline-whitted's
   first-bounce dome gather, every hit lane compared, and ptxas's
   registers and spills of every instantiation of the gather's kernel
   (with and without bits, with and without counters) and of
   csrc/isect.cu's kernels (a spill fails).  Tolerances:
   hit/tri equal on all but 1e-4 of the lanes, t/u/v within 1e-6
   relative; occlusion counts equal on all but 1e-4 of the lanes and
   within 1 there; bits and any-hit answers equal on all but 1e-4 of the
   lanes / rays;
4. the headline frames (bench.py's configurations for lucille_tpu): the
   bundled scene at 640x480, 3x3 samples, 64 AO rays, tile 240, rendered
   by the port's Renderer on the card into an .hdr through the port's
   display driver and read back: finite, mean in range, the path's
   kernels launched, no other kernel, no plain twin, no tile waiting on
   the card while it is enqueued; the warm frame seconds (best of 2) and
   Mrays/s.  First as shipped, with its sunsky
   light (the sunsky gather: closest hit, AO gather with bits, the sky
   over them, dense any-hit), then without it (plain AO: closest hit, AO
   gather);
5. the 80x60 frames against CPU-lucille's own: plain AO against
   tests/golden/ao_80x60_ref.hdr (tests/test_render.py's bound), sunsky
   AO with the reference's turbidity-0 sun against
   tests/golden/sunsky_80x60_ref.hdr (tests/test_sunsky_golden.py's
   bounds);
6. the dense path's upper range: the heightfield at 160x120, 2x2, 64 rays,
   with the checks and timing of phase 4;
7. the tile-BVH kernels against their plain twins on the first 128x128x4
   tile of bench_large's heightfield at n = 256 (130,050 triangles) and
   n = 724 (1,045,458): the closest hit on the tile's eye rays, the
   any-hit on its 8x8-strata gather rays with the sampler's jitter.  The
   kernels run the whole tile; the twins (brute force over every
   triangle) a slice of rays.  Tolerances: hit masks equal on all but
   1e-4 of the rays, triangle ids on all but 1e-3 (exact ties in t
   across leaves), t/u/v within 1e-6 relative; occlusion equal on all
   but 1e-4 of the rays; then the any-hit with a finite per-ray tmax on
   the tile's shading points (the shadow rays' case), on a slice of the
   hit lanes.  Their bounds count the work the data needs (`need_walk`:
   the tree walked near child first, real triangles only, an any-hit
   stopping at its first hit), on every eye ray and on a random sample
   of the gather rays, and the bytes of the nodes and leaves' real
   triangles the rays reach; the closest hit walks that walk exactly:
   on every eye ray its triangle and t equal need_walk's, and its node
   visits and triangle tests equal need_walk's counts
   (`check_closest_walk`); both kernels print their lane node visits and
   triangle tests against that need, their walks' steps and SIMT
   efficiency (`walk_report`), and their registers and spills (a spill
   fails);
8. the large-scene frames: both heightfields at bench_large's
   configuration, uncut (160x120, 2x2 samples, 64 AO rays, tile 128),
   with the checks of phase 4 (both BVH kernels launched, no dense
   kernel, no twin), the warm frame seconds and Mrays/s, and the host's
   scene, compile and tile-BVH build seconds; then the n = 256 terrain
   under the bundled scene's sunsky line (the sunsky gather on the tile
   BVH);
9. the heightfield at n = 91 rendered on the dense tiles and on the tile
   BVH: the two draw their jitter differently (compacted slot against
   raster lane), so only the means over hit pixels are held, within 0.01;
10. the fused tile-BVH AO gather (kernel 6, LUCILLE_BVH_AO=fused) against
   its plain twin on the first tile of both heightfields at 8x8 strata,
   and of the n = 256 one at 2x2 strata with the inputs of a Whitted
   frame's dome gather (its other layout: one warp a block); the kernel
   on the whole tile, the twin on a slice of its compacted slots; counts
   equal on all but 1e-4 of the slots and within 1; the bound from
   `need_walk` on a random sample of the live slots, whose counts must
   equal the kernel's, and the walk's work against it as in phase 7.
   Then both closest hits with a bounce
   wavefront's active mask (half the rays live) against their twins
   (phase 3's and 7's tolerances; dead rays report a miss), the tile
   BVH's at n = 256 and 724, its live rays held to need_walk's walk
   exactly as in phase 7;
11. the integrator frames, each with the checks and timing of phase 4:
   bench.py's `whitted` frame (the bundled scene without its sunsky line,
   640x480, 3x3, tile 240: the default dome, so Whitted gathers it
   through the dense AO gather), the same scene path traced, the bundled
   scene as shipped under Whitted (the sky and the sun by shadow rays:
   the dense any-hit), the n = 256 terrain under Whitted with the cone
   gather and with the fused one, and both terrains' AO frames with the
   fused gather;
12. an 80x60 Whitted frame of the bundled scene on the card against the
   same frame on the CPU (the plain twins), one numpy stream fed to
   both: ray counts within 1e-3, pixels within 1e-3 on all but 1%;
13. the fused gather's frames against the cone gather's (their jitter
   belongs to compacted slots against raster lanes): means over hit
   pixels within 0.01;
14. the dense AO scan: the n = 258 terrain (132,098 triangles, above
   the fused gather's 131,072) on the dense tiles at 80x60, plain and
   under the sunsky line, through the closest hit and the any-hit once
   a stratum, with phase 4's checks, against the same frames on the
   tile BVH (`check_dense_scan`); first kernels 1 and 2 on the first
   tile of that frame (6,400 rays on 1,033 tiles), where they split the
   triangle range across the grid, against their twins on a slice
   (`check_split_kernels`, phase 3's tolerances and printout);
15. kernel 1 with a finite per-ray tmax (the dirt map's gather) against
   its twin (`check_tmax_kernels`): at the gather's shape, the bundled
   scene's first 240x240 tile at 3x3 (518,400 rays from the shading
   points, one stratum's directions, tmax the gather distance, the eye
   hits live), then on the split path, the n = 258 terrain's first tile
   (6,400 rays on 1,033 tiles) with a random finite tmax; phase 3's
   tolerances, a miss t = +inf, dead rays missing, a ray whose tmax is
   its own hit's t missing; its lane tests against `dense_need`'s up to
   min(hit, tmax), its time and bound;
16. the dirt map at full width, each frame with phase 4's checks:
   bundled-dirtmap (the bundled scene without its sunsky line, 640x480,
   3x3, 64 rays, tile 240, dense: kernel 1 alone, 1 + 64 launches a
   tile), heightfield256-dirtmap (bench_large's n = 256 terrain at its
   settings, tile BVH: kernel 4 alone); then an 80x60 dirt-map frame (16
   gather rays) on the card against the CPU's twins with phase 12's
   bound;
17. bundled-dof: the bundled scene under a DepthOfField line whose focal
   plane crosses it (`DOF_LINE`), at the headline settings as AO, with
   phase 4's checks, then its 80x60 frame against the CPU's;
18. textured-ao: lucille's texcoord scene (a matte quad textured by a
   1024x1024 checker that the port's write_tex and write_exr write at
   run time) at 640x480, 3x3, 64 rays, with phase 4's checks and both
   the dark and the bright squares on it; the .exr's atlas equal to the
   .tex's; its 80x60 frame against the CPU's;
19. recover: the headline AO frame with a tile checkpoint, stopped after
   3 of its 6 tiles, then recovered: equal to the uninterrupted frame
   exactly, only the 3 missing tiles enqueued, the checkpoint removed;
20. the CLI on the card in a subprocess (`--method dirtmap --maxraydepth
   2 --display openexr --gather-rays 16`), its .exr read back;
   each of phases 15-20 prints its wall seconds;
21. kernels 2 and 5 on the environment samplers' shadow rays
   (`check_env_any_hits`): the first bounce's importance-sampled texels
   and 4 structured directions (`env_shadow_rays`) of the bundled
   scene's headline tile (dense) and the n = 256 terrain's first tile
   (tile BVH) under a 2048x1024 lat-long sky written at run time (a sun
   disc ~1000x its zenith, a darker ground; `env_dir`), against their
   twins on a slice of the live rays with phase 3's tolerances, with
   their device times and bounds;
22. this slice's full-width frames with phase 4's checks:
   bundled-ibl-whitted (the headline settings as Whitted, depth 8,
   under the sky: kernels 1 and 2), heightfield256-ibl-whitted
   (bench_large's n = 256 frame under the sky, importance-sampled:
   kernels 4 and 5) and bundled-pipeline (headline-ao with miefog, the
   background imager and MOSAICdisplace: kernels 1 and 3);
23. 80x60 frames on the card against the CPU's twins with phase 12's
   bound: Whitted at depth 1 under each sampler (bruteforce on a 16x8
   sky), the sky's 1000x1000 angular resampling, the path tracer under
   the sky, AO under fog, depthcue, MOSAICfog (mist) and miefog, the
   imager, MOSAICdisplace;
24. an 80x60 imager frame stopped after 6 of its 20 tiles and recovered:
   its image and its checkpoint's image and alpha equal the uninterrupted
   frame's exactly;
25. the CLI's entry point at 80x60 with --display socket (no viewer
   spawned) streaming to a listener on a free port: the reassembled
   frame equals the .pfm --display file writes; each of phases 21-25
   prints its wall seconds;
26. the shader method's full-width frames (`check_shader_frames`), each
   with phase 4's checks, its device ops, busy share and idle share from
   one profiled frame (profile_frame.frame_profile), the launches of its
   kernels against the count its path must make, and its rays against
   lucille_tpu's count (the eye rays alone): bundled-shader-sl (the
   headline settings, the scene as shipped, whitted.sl, written at run
   time into `shader_dir`, bound to every geometry: kernel 1 on 15
   wavefronts a tile, kernel 2 on each wavefront's illuminance shadow
   rays, one a light), bundled-shader-ao (the scene without its sunsky
   line under the built-in ambientocclusion: kernel 1, then 64 launches
   of kernel 2 a tile) and heightfield256-shader (the n = 256 terrain's
   frame, plastic under a distant light: kernel 4, then kernel 5 for
   the diffuse and the specular shadow rays);
27. 80x60 frames under the shader method on the card against the CPU's
   twins (`check_frame_twins`, 1x1 samples): each built-in surface,
   whitted.sl, an illuminance shader under a point and under an area
   light, a noise() shader, shaders whose Ci is uniform (flatred with
   its parameter at its default, a constant triple) or reads a uniform
   triple computed from a parameter and literals; each surface's first
   frame in a new Renderer with no tile waiting on the card
   (`no_host_sync`, no warm-up); then AO frames under a displacement, an
   atmosphere and an imager compiled from .sl;
28. the CLI's entry point in this process with --method shader on the
   whitted.sl scene at 160x120, its .hdr equal to the Renderer's frame
   through the same driver; each of phases 26-28 prints its wall
   seconds;
29. the uniform grid's DDA walk (csrc/ugrid.cu, `group_lanes` lanes a
   ray; it stands for lucille_tpu's lax.while_loop, ugrid.py:166)
   against its lock-step twin (`check_grid_kernels`): the closest hit on
   the first tile's eye rays and the any-hit on one stratum of the AO
   scan's gather rays from their hits, on the bundled scene's headline
   tile (518,400 rays, a 9^3 grid, a lane a ray) and the n = 256
   terrain's first tile (65,536 rays, 130,050 triangles, a 64^3 grid, 8
   lanes a ray): tri, t, u, v, occlusion and the walk's counters
   (ntests, ntrav) equal exactly, also from the calls the render paths
   make and that are timed; ms a launch as the render paths launch it
   (the any-hit without counters), the twin's ms, the bound from the
   counted work, the warps' own advance and chunk steps and the SIMT
   efficiency, registers (a spill or a stack frame in any entry fails);
30. the grid's, the dense requests' and the re-binned gather's full-width
   frames with phase 4's checks, each with its
   launches against its path's count, its rays against the same scene's
   frame on its default accel, and one profiled frame's device ops,
   busy and idle share (`check_accel_frames`): headline-ao-grid and
   heightfield256-grid (the grid walk: 1 + 64 launches a tile),
   headline-ao-bruteforce and headline-ao-mxu (lucille_tpu's dense
   requests, input order: kernel 1, then kernel 2 on each of the 64
   strata) and heightfield256-rebinned (LUCILLE_BVH_AO=rebinned: kernel
   4, then kernel 5 once a tile on its 4,194,304 sorted gather rays);
31. 80x60 frames of those paths on the card against the CPU's twins
   (phase 12's bound): AO and Whitted on the grid, AO under bruteforce
   and mxu, the re-binned gather on the 35x35 heightfield;
32. inverse rendering (lucille_tpu_torch.diff, the inverse-render
   example's scene) at 640x480, 4 samples, depth 3: forward and
   backward seconds, the peak memory torch allocated, five Adam steps on
   mat_kd and mat_color whose loss must fall; at 80x60 every gradient on
   the card against the CPU's twins (`check_inverse_render`);
33. single_scattering on the headline tile's hit lanes against the CPU's
   twins, and tools/bvh_viz.py's counters and heatmap on the card equal
   to the CPU's (`check_library_paths`); each of phases 29-33 prints its
   wall seconds;
34. a JSON line of per-kernel results (each with the least time the card
   could take for its work, `bound_ms`, from the counts below; kernel
   1's entries include its finite-tmax cases; the grid's two entry
   points beside the six TPU kernels' ports), the card's line, and last
   {"ok": true, "device": {...}};
35. (run before 34) the Renderer's mesh path and the CLI in two
   processes joined by torch.distributed (`check_mesh`): the headline
   AO frame on a one-card mesh against phase 4's, under no_host_sync;
   the CLI's frame in two processes on the one card byte-equal to one
   process's; __graft_entry__.dryrun_multichip's four integrators on
   the mesh of every card against the same frames without a mesh; the
   headline frame over every card where there are two or more; its
   wall seconds;
37. (run after 4) the sunsky gather's sky (csrc/ao.cu sky_gather_kernel;
   it stands for lucille_tpu's jnp glue, _sunsky_megakernel) on the
   headline tile's compacted lanes and kernel 3b's bits of them against
   its twin (`check_sky_gather`): every hit lane within 1e-5 relative
   plus 1e-3, its ms, the twin's, the bound, the open share of the
   (lane, stratum) pairs, its registers and spills, and 6 launches a
   frame;
36. (run before 34) the entry points outside the package core
   (`check_tools`), each with its wall seconds beside the card's name
   and power limit: (a) the fur example at its defaults (400 strands,
   25,602 triangles, the tile BVH) through its entry point, then with
   phase 4's checks and timing, kernels 4 and 5 against their twins on
   its first tile (phase 7; its entries join theirs in the results
   line), and its 80x60 frame against the CPU's twins (phase 12's
   bound); (b) the bundled scene at 640x480 through the CLI with
   --display socket: the port's viewer spawned for real (argv
   `-m lucille_tpu_torch.tools.rockenfield`, nothing under tools_tpu;
   every pixel reassembled; exit 0), then the viewer started by hand
   with --out: its .hdr byte-equal to --display file's in raster order;
   (c) the sisgen command on the 2048x1024 sky, timed: its .npz equal to
   the samples the Renderer generates from the map, and the structured
   IBL frame with it as the sisfile equal to the generated samples'
   frame; (d) the n = 256 terrain as an OBJ through obj2rib and the CLI:
   kernels 4 and 5 only, no twin.

It needs one card and the repository around it: run from a directory
holding only this file, it fails.

The heightfield is a copy of bench_large.heightfield_scene's terrain and
camera (`heightfield_grid`, `HEIGHTFIELD_CAMERA`); the tests hold the two
equal.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BUNDLED_RIB = ROOT / "tests" / "golden" / "sunsky_scene.rib"
# rendered frames, beside the kernel build (both gitignored)
OUT = ROOT / "lucille_tpu_torch" / "_build" / "smoke"
TILE = 240
# kernel name -> (source, the TPU kernel it replaces)
SOURCES = {
    "closest_hit": ("lucille_tpu_torch/csrc/isect.cu",
                    "lucille_tpu/accel/pallas_isect.py:57"),
    "any_hit": ("lucille_tpu_torch/csrc/isect.cu",
                "lucille_tpu/accel/pallas_isect.py:390"),
    "ao_occlusion": ("lucille_tpu_torch/csrc/ao.cu",
                     "lucille_tpu/accel/pallas_ao.py:109"),
    "ao_occlusion_bits": ("lucille_tpu_torch/csrc/ao.cu",
                          "lucille_tpu/accel/pallas_ao.py:109"),
    "bvh_closest_hit": ("lucille_tpu_torch/csrc/bvh.cu",
                        "lucille_tpu/accel/pallas_bvh.py:310"),
    "bvh_any_hit": ("lucille_tpu_torch/csrc/bvh.cu",
                    "lucille_tpu/accel/pallas_bvh.py:598"),
    "bvh_ao_fused": ("lucille_tpu_torch/csrc/bvh.cu",
                     "lucille_tpu/accel/pallas_bvh.py:810"),
    # the grid's DDA walk stands for a JAX loop (`_traverse`'s
    # lax.while_loop), not a Pallas kernel
    "grid_closest_hit": ("lucille_tpu_torch/csrc/ugrid.cu",
                         "lucille_tpu/accel/ugrid.py:166"),
    "grid_any_hit": ("lucille_tpu_torch/csrc/ugrid.cu",
                     "lucille_tpu/accel/ugrid.py:166"),
    # the sunsky gather's sky stands for jnp glue (_sunsky_megakernel's
    # scan over the strata), not a Pallas kernel
    "sky_gather": ("lucille_tpu_torch/csrc/ao.cu",
                   "lucille_tpu/transport/ao.py:286"),
}

# kernel name -> its CUDA symbol, as the profiler names it
SYMBOLS = {"closest_hit": "closest_hit_kernel", "any_hit": "any_hit_kernel",
           "bvh_closest_hit": "bvh_closest_kernel",
           "bvh_any_hit": "bvh_any_kernel"}

# The card's peaks for bound_ms (NVIDIA H100 SXM data sheet, at 700 W):
# f32 outside the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations, read from csrc/ (a divide, min, max or compare counts as
# one): a Moller-Trumbore test (isect.cu Ray::hits, bvh.cu closest), the
# BVH any-hit's signed-volume test, one (stratum, triangle) test of the AO
# gather, a ray against a tile's box, a tile-BVH node visit (two child
# boxes and the ordering), and the fused gather's per-walk set-up (the
# stratum's direction from the jitter and basis, and its reciprocals).
MT_OPS, SV_OPS, AO_OPS, SLAB_OPS, NODE_OPS = 56, 58, 30, 25, 56
DIR_OPS = 55
# the sunsky gather's sky (csrc/ao.cu sky_gather_kernel) for one open
# (lane, stratum) pair: the stratum's direction (43), the Preetham sky
# along it and the sum (124), a transcendental counted once
SKY_OPS = 167
# a grid walk's cell advance (csrc/ugrid.cu: the nearest boundary of
# three, the settle and exit tests, the step, the next cell's index)
DDA_OPS = 16
# rays on which need_walk counts the tile-BVH any-hits' needed work
N_NEED = 65536

# f-stop 2 and focal length 1 (a lens of radius 0.25), focused at 15.5:
# the bundled scene's camera sits 15.53 from its centre, so the focal
# plane crosses the scene
DOF_LINE = "DepthOfField 2.0 1.0 15.5\n"
# the textured frame's texture: a 1024x1024 checker of 8x8 squares
CHECKER, CHECKER_CELL = 1024, 128

# the environment frames' maps: a 2048x1024 lat-long sky (a real probe's
# size), its 1000x1000 angular resampling, and a 16x8 sky for the
# bruteforce sampler's 80x60 frame (its texels are its shadow wavefronts,
# and the CPU's twin traces each against every triangle);
# the sun 40 degrees up, its disc 1.5 degrees wide, ~1000x the sky
SKY, PROBE, SKY_SMALL = (2048, 1024), 1000, (16, 8)
SUN_DIR = (0.55, 0.64, 0.53)
SUN_RADIUS_DEG, SUN_GAIN = 1.5, 1000.0
IBL_SAMPLERS = ("cosweight", "importance", "stratified", "structured",
                "bruteforce")
# the pipeline frame: miefog, the background imager, MOSAICdisplace
PIPELINE_IMAGER = 'Imager "background" "bgcolor" [0.35 0.45 0.6]\n'

# the shader method's sources, written at run time (`shader_dir`):
# tests/test_transport.py's whitted.sl; an illuminance and a noise()
# surface; TestShadedIntegrator's flatred, a constant Ci and a uniform
# triple computed from a parameter and literals; a displacement, an
# atmosphere and an imager stage (modelled on tests/test_pipeline.py's)
SHADER_SOURCES = {
    "whitted": (
        "surface whitted(float eta = 1.5; float Kd = .8; float Kr = .8;"
        "  float Kt = .2; float Ks = .2; float Kss = 2) {\n"
        "  normal Nn = faceforward(normalize(N), I);\n"
        "  Ci = Kd * ambient();\n"
        "  illuminance(P, Nn, PI/2) { Ci += Kd * Cl * (L . Nn); }\n"
        "  Ci += Ks * trace(P, reflect(I, Nn));\n"
        "  vector T = refract(I, Nn, (N.I) < 0 ? eta : 1/eta);\n"
        "  if (length(T) != 0.0) Ci += Kt * trace(P, T);\n"
        "}\n"),
    "lambert": (
        "surface lambert(float Kd = 0.8; color tint = (1, 0.9, 0.8)) {\n"
        "  normal Nn = faceforward(normalize(N), I);\n"
        "  illuminance(P, Nn, PI/2) { Ci += Kd * tint * Cs * Cl"
        " * max(L . Nn, 0); }\n"
        "}\n"),
    "noisy": (
        "surface noisy(float freq = 4) {\n"
        "  Ci = Cs * noise(P * freq) + 0.25 * noise(s * 8, t * 8);\n"
        "  if (noise(P * 2) > 0.5) Ci = Ci * (1, 0.5, 0.25);\n"
        "}\n"),
    "flatred": "surface flatred(float K = 1) { Ci = K * (1, 0.25, 0.1); }\n",
    "constred": "surface constred() { Ci = (1, 0, 0); }\n",
    "tinted": (
        "surface tinted(float K = 0.5) {\n"
        "  color c = K * (1, .25, .1) + (0.5, 0, 0.25);\n"
        "  Ci = c * Cs * diffuse(N);\n"
        "}\n"),
    "bumps": (
        "displacement bumps(float amp = 0.05) {\n"
        "  P += amp * normalize(N) * (noise(P * 4) - 0.5);\n"
        "  N = calculatenormal(P);\n"
        "}\n"),
    "haze": (
        "volume haze(float d = 30; color bg = (0.5, 0.6, 0.8)) {\n"
        "  float f = 1 - exp(-length(I) / d);\n"
        "  Ci = mix(Ci, bg, f);\n"
        "  if (ycomp(P) > 1) Ci = Ci * 0.9;\n"
        "}\n"),
    "vignette": (
        "imager vignette(color bg = (0.2, 0.1, 0.3)) {\n"
        "  float r = distance(P, (0.5, 0.5, 0));\n"
        "  Ci = Ci * (1 - 0.5 * r) + (1 - alpha) * bg;\n"
        "}\n"),
}
# test_torch_whitted's point light and area light, over the bundled scene
POINT_LIGHT = ('LightSource "pointlight" 2 "intensity" [12.0] '
               '"from" [-1 4 1]\n')
AREA_LIGHT = ('AttributeBegin\nAreaLightSource "arealight" 3 "intensity" '
              '[3.0]\nPointsPolygons [4] [0 3 2 1] "P" '
              '[-1 4 -1  1 4 -1  1 4 1  -1 4 1]\nAttributeEnd\n')
DISTANT_LIGHT = ('LightSource "distantlight" 1 "intensity" [1.0] '
                 '"from" [2 6 3] "to" [0 0 0]\n')

HEIGHTFIELD_CAMERA = (
    'Projection "perspective" "fov" [45.0]\n'
    'Orientation "rh"\n'
    "ConcatTransform [0.994530 0.008385 -0.104111 0.000000 "
    "0.052799 0.819679 0.570385 0.000000 "
    "0.090120 -0.572762 0.814753 0.000000 "
    "-0.000009 -0.000015 -15.529361 1.000000 ]\n"
)


def front_end():
    """The port's (RiState, parse_rib)."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib

    return RiState, parse_rib


def sunsky_line() -> str:
    """The bundled scene's AreaLightSource "sunsky" line."""
    return next(l for l in BUNDLED_RIB.read_text().splitlines()
                if 'AreaLightSource "sunsky"' in l)


def bundled_state(width, height, pixelsamples=None, gather=None,
                  sunsky=True, api=None, method=None, dof=False, light=None,
                  head="", world="", accel=None):
    """tests/golden/sunsky_scene.rib, the reference's
    ambient_occlusion.rib (322 triangles) with its sunsky light (as
    shipped), or without that line for plain AO, or with RIB text
    `light` in its place; with dof, under DOF_LINE; `head` RIB lines
    before WorldBegin, `world` right after it; parsed in memory, and
    rendered by `method` (default the RIB's, AO) on `accel` (default the
    RIB's, auto)."""
    RiState, parse_rib = api or front_end()
    text = BUNDLED_RIB.read_text()
    if light is not None:
        text = text.replace(sunsky_line() + "\n", light, 1)
    elif not sunsky:
        text = "".join(l for l in text.splitlines(keepends=True)
                       if 'AreaLightSource "sunsky"' not in l)
    text = text.replace("WorldBegin\n", head + "WorldBegin\n" + world, 1)
    if dof:
        text = text.replace("WorldBegin", DOF_LINE + "WorldBegin", 1)
    s = RiState()
    parse_rib(text, s)
    s.Format(width, height)
    if pixelsamples is not None:
        s.PixelSamples(pixelsamples, pixelsamples)
    if gather is not None:
        s.options.gather_nsamples = gather
    if method is not None:
        s.options.render_method = method
    if accel is not None:
        s.options.accel_method = accel
    return s


def heightfield_grid(n: int):
    """bench_large.heightfield_scene's analytic terrain: ((n*n, 3) f32
    vertices, ((n-1)^2, 4) i64 quads)."""
    i = np.arange(n, dtype=np.float32)
    x = -5.0 + 10.0 * i / (n - 1)
    xx, zz = np.meshgrid(x, x)  # zz varies along rows like the C driver
    yy = 0.5 * np.sin(1.3 * xx) * np.cos(1.1 * zz) + 0.25 * np.sin(
        2.7 * xx + 1.0
    ) * np.sin(1.9 * zz)
    P = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    jj, ii = np.meshgrid(
        np.arange(n - 1, dtype=np.int64), np.arange(n - 1, dtype=np.int64),
        indexing="ij",
    )
    a = jj * n + ii
    quads = np.stack([a, a + 1, a + n + 1, a + n], axis=-1).reshape(-1, 4)
    return P, quads


def heightfield_state(n, width=160, height=120, pixelsamples=2, gather=64,
                      accel="auto", sunsky=False, api=None, method=None,
                      light=None, world=""):
    """bench_large's scene: the camera parsed from RIB text, the terrain
    handed to RiPointsPolygons as one mesh (identity transform), and
    optionally the bundled scene's sunsky line or the RIB text `light`;
    RIB text `world` binds attributes to the terrain."""
    RiState, parse_rib = api or front_end()
    P, quads = heightfield_grid(n)
    s = RiState()
    parse_rib(HEIGHTFIELD_CAMERA, s)
    s.Format(width, height)
    s.PixelSamples(pixelsamples, pixelsamples)
    s.WorldBegin()
    if sunsky:
        parse_rib(f"AttributeBegin\n{sunsky_line()}\nAttributeEnd\n", s)
    if light is not None:
        parse_rib(f"AttributeBegin\n{light}AttributeEnd\n", s)
    s.AttributeBegin()
    if world:
        parse_rib(world, s)
    s.Transform(np.eye(4).reshape(-1))
    s.PointsPolygons(
        np.full(len(quads), 4, np.int64), quads.reshape(-1), {"P": P}
    )
    s.AttributeEnd()
    s.WorldEnd()
    s.options.gather_nsamples = gather
    s.options.accel_method = accel
    if method is not None:
        s.options.render_method = method
    return s


def write_checker(tex_dir) -> None:
    """The textured frame's checker (1 and 0 squares) written by the
    port's own codecs as checker.tex and checker.exr in tex_dir."""
    from lucille_tpu_torch.imageio.exr import write_exr
    from lucille_tpu_torch.imageio.tex import write_tex

    y, x = np.mgrid[0:CHECKER, 0:CHECKER] // CHECKER_CELL
    img = np.repeat((((x + y) % 2) == 0)[..., None], 3, axis=-1).astype(
        np.float32)
    write_tex(Path(tex_dir) / "checker.tex", img)
    write_exr(Path(tex_dir) / "checker.exr", img)


@functools.cache
def checker_dir() -> tempfile.TemporaryDirectory:
    """A temporary directory holding write_checker's files, made once a
    process and removed at its exit (.name is its path)."""
    d = tempfile.TemporaryDirectory(prefix="lucille_checker_")
    write_checker(d.name)
    return d


def textured_state(width, height, tex_name="checker.tex", pixelsamples=3,
                   gather=64, api=None):
    """lucille's texcoord regression scene (lucille_tpu's
    tests/test_texture.py:88-115): one matte quad facing the camera,
    textured by the checker through Option "searchpath" "texture"."""
    RiState, parse_rib = api or front_end()
    s = RiState()
    parse_rib(
        'Projection "perspective" "fov" [45]\n'
        f'Option "searchpath" "texture" ["{checker_dir().name}"]\n'
        "WorldBegin\n"
        f'Surface "matte" "texturename" ["{tex_name}"]\n'
        'Polygon "P" [ 1 1 3  1 -1 3  -1 -1 3  -1 1 3 ]\n'
        '  "facevertex float s" [0 0 1 1] "facevertex float t" [0 1 1 0]\n'
        "WorldEnd\n", s)
    s.Format(width, height)
    s.PixelSamples(pixelsamples, pixelsamples)
    s.options.gather_nsamples = gather
    return s


DRYRUN_METHODS = ("ao", "whitted", "pathtrace", "shader")


def dryrun_state(method: str, td: str, api=None):
    """__graft_entry__.dryrun_multichip's scene for `method` at 64x32, one
    sample a pixel, 4 gather rays, depth 2 (__graft_entry__.py:151-210):
    lucille_tpu's self-contained scene (a triangle over a ground plane);
    AO with a checker .hdr bound to every material, Whitted with
    ks = kd = 0.5, the path tracer, and the shader method's mirrormatte,
    whose trace() recurses, under a distant light.  Files go in td."""
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    RiState, parse_rib = api or front_end()
    world = ('PointsPolygons [4] [0 1 2 3] "P" [-5 0 -5  5 0 -5  5 0 5  '
             '-5 0 5]\n'
             'PointsPolygons [3] [0 1 2] "P" [-1 0 -1  1 0 -1  0 2 0]\n')
    head = ""
    if method == "shader":
        Path(td, "mirrormatte.sl").write_text(
            "surface mirrormatte(float Kd = 0.7; float Kr = 0.3;) {\n"
            "  normal Nf = faceforward(normalize(N), I);\n"
            "  Ci = Cs * (Kd * diffuse(Nf)"
            " + Kr * trace(P, reflect(normalize(I), Nf)));\n"
            "  Oi = 1;\n"
            "}\n")
        head = f'Option "searchpath" "shader" ["{td}"]\n'
        world = ('LightSource "distantlight" 1 "intensity" [1.0]\n'
                 'Surface "mirrormatte" "Kd" [0.7] "Kr" [0.3]\n'
                 + world.replace("[0 1 2 3]", "[0 3 2 1]"))
    s = RiState()
    parse_rib(head + 'Display "t.hdr" "file" "rgb"\nPixelSamples 2 2\n'
              'Projection "perspective" "fov" [45]\nOrientation "rh"\n'
              "ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -1 -8 1]\n"
              "WorldBegin\n" + world + "WorldEnd\n", s)
    s.Format(64, 32)
    if method == "whitted":
        for g in s.scene.geoms:
            g.attrs.material.ks = g.attrs.material.kd = 0.5
    if method == "ao":
        tex = np.indices((8, 8)).sum(0) % 2
        write_hdr(Path(td) / "checker.hdr", np.stack(
            [tex, 1 - tex, np.ones_like(tex)], -1).astype(np.float32))
        s.options.searchpaths.append(td)
        for g in s.scene.geoms:
            g.attrs.material.texture = "checker.hdr"
    s.options.gather_nsamples = 4
    s.options.max_ray_depth = 2
    s.options.render_method = method
    s.options.current_display().sampling_rates = (1.0, 1.0)
    return s


def sky_image(w: int, h: int) -> np.ndarray:
    """A lat-long sky in lights/ibl.latlong_directions' layout (row 0 the
    zenith): blue above the horizon, brightening toward it; a sun disc
    along SUN_DIR, SUN_GAIN times the sky's zenith; a darker ground."""
    from lucille_tpu_torch.lights.ibl import latlong_directions

    d, _ = latlong_directions(h, w)
    y = d[..., 1:2]
    up = np.clip(y, 0.0, 1.0)
    zenith, horizon = np.array([0.25, 0.45, 1.0]), np.array([0.9, 0.95, 1.1])
    sky = horizon + (zenith - horizon) * np.sqrt(up)
    ground = np.array([0.12, 0.1, 0.08]) * (1.0 + np.clip(-y, 0.0, 1.0))
    img = np.where(y >= 0.0, sky, ground)
    sun = np.asarray(SUN_DIR) / np.linalg.norm(SUN_DIR)
    disc = d @ sun > np.cos(np.radians(SUN_RADIUS_DEG))
    img[disc] = SUN_GAIN * zenith
    return img.astype(np.float32)


def angular_probe(img: np.ndarray, n: int) -> np.ndarray:
    """The lat-long map img resampled as an (n, n) Debevec angular map
    (view axis -z; lights/envmap.EnvMap.load_sis's inverse
    parametrization), bilinear."""
    from lucille_tpu_torch.lights.envmap import _np_bilinear

    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    u, v = np.meshgrid(c, -c)
    rho = np.hypot(u, v)
    theta = np.pi * np.minimum(rho, 1.0)
    s = np.where(rho > 1e-9, np.sin(theta) / np.maximum(rho, 1e-9), 0.0)
    d = np.stack([u * s, v * s, -np.cos(theta)], axis=-1)
    lat = np.arccos(np.clip(d[..., 1], -1.0, 1.0)) / np.pi
    lon = (np.arctan2(d[..., 2], d[..., 0]) + np.pi) / (2.0 * np.pi)
    return _np_bilinear(img, lon, lat).astype(np.float32)


@functools.cache
def env_dir() -> tempfile.TemporaryDirectory:
    """A temporary directory (.name its path, removed at exit) holding the
    environment frames' maps, written by the port's RGBE codec: sky.hdr
    (SKY), probe.hdr (its PROBE x PROBE angular resampling), sky16.hdr
    (SKY_SMALL) and disp.hdr, the pipeline frame's DispMap; and
    sky_sis.npz, sky.hdr's structured samples."""
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    d = tempfile.TemporaryDirectory(prefix="lucille_env_")
    sky = sky_image(*SKY)
    write_hdr(Path(d.name) / "sky.hdr", sky)
    write_hdr(Path(d.name) / "probe.hdr", angular_probe(sky, PROBE))
    write_hdr(Path(d.name) / "sky16.hdr", sky_image(*SKY_SMALL))
    # the sky's 64 structured samples, generated once (seconds of NumPy at
    # this size) and bound as a sisfile wherever the sampler is structured
    from lucille_tpu_torch.lights.envmap import SIS_SAMPLES
    from lucille_tpu_torch.lights.sisgen import generate_sis_samples

    dirs, rgb = generate_sis_samples(sky, SIS_SAMPLES)
    np.savez(Path(d.name) / "sky_sis.npz", dirs=dirs, rgb=rgb)
    y, x = np.mgrid[0:256, 0:256] / 255.0
    bumps = 0.5 + 0.5 * np.sin(9.0 * x + 0.3) * np.cos(7.0 * y + 0.2)
    write_hdr(Path(d.name) / "disp.hdr",
              np.repeat(bumps[..., None], 3, -1).astype(np.float32))
    return d


def ibl_line(sampler="cosweight", name="sky.hdr", kind="ibl") -> str:
    """The RIB line of an environment light on env_dir()'s map `name`
    (structured on sky.hdr: its samples bound as the sisfile)."""
    d = env_dir().name
    sis = (f' "sisfile" ["{d}/sky_sis.npz"]'
           if sampler == "structured" and name == "sky.hdr" else "")
    return (f'LightSource "{kind}" 1 "texture" ["{d}/{name}"] '
            f'"sampling" ["{sampler}"]{sis}\n')


def pipeline_world() -> str:
    """The pipeline frame's stages, bound after WorldBegin: miefog and
    MOSAICdisplace on every geometry (the imager is PIPELINE_IMAGER)."""
    return ('Atmosphere "miefog" "density" [0.03] "sundir" '
            f'[{" ".join(str(v) for v in SUN_DIR)}] "intensity" [1.5]\n'
            'Displacement "MOSAICdisplace" "DispMap" '
            f'["{env_dir().name}/disp.hdr"] "Disp" [0.05] "Mid" [0.5]\n')


@functools.cache
def shader_dir() -> tempfile.TemporaryDirectory:
    """A temporary directory (.name its path, removed at exit) holding
    SHADER_SOURCES as <name>.sl."""
    d = tempfile.TemporaryDirectory(prefix="lucille_sl_")
    for name, src in SHADER_SOURCES.items():
        (Path(d.name) / f"{name}.sl").write_text(src)
    return d


def shader_head() -> str:
    """The Option line that puts shader_dir() on the shader search path."""
    return f'Option "searchpath" "shader" ["{shader_dir().name}"]\n'


def shader_sl_state(width=640, height=480, pixelsamples=3):
    """bundled-shader-sl: the bundled scene as shipped (its sunsky and
    sun lights) under the shader method, whitted.sl bound to every
    geometry."""
    return bundled_state(width, height, pixelsamples, head=shader_head(),
                         world='Surface "whitted"\n', method="shader")


def shader_ao_state(width=640, height=480, pixelsamples=3):
    """bundled-shader-ao: the bundled scene without its sunsky line under
    the built-in ambientocclusion surface (64 samples)."""
    return bundled_state(width, height, pixelsamples, sunsky=False,
                         world='Surface "ambientocclusion"\n',
                         method="shader")


def shader_hf_state():
    """heightfield256-shader: bench_large's n = 256 frame on the tile BVH,
    plastic under one distant light."""
    return heightfield_state(256, light=DISTANT_LIGHT, method="shader",
                             world='Surface "plastic"\n')


class SocketListener:
    """A viewer stand-in for the socket display: listens on a free
    localhost port (`port`), serves one renderer in a thread and reads the
    sockdrv protocol (display/sockdrv.py: NEW w h, PIXEL batches of x y r
    g b, FINISH).  After `join()`: `raw`, every byte received; `frame`,
    the (h, w, 3) f32 frame the batches reassemble, raster rows; and
    `finished`, whether FINISH came."""

    def __init__(self, timeout: float = 120.0):
        import socket
        import threading

        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(timeout)
        self.port = self.srv.getsockname()[1]
        self.raw = b""
        self.frame = None
        self.finished = False
        self.error = None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _recv(self, conn, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the renderer closed the socket")
            buf += chunk
        self.raw += buf
        return buf

    def _serve(self):
        import struct

        try:
            conn, _ = self.srv.accept()
            with conn:
                while True:
                    (cmd,) = struct.unpack("<i", self._recv(conn, 4))
                    if cmd == 0:  # NEW
                        w, h = struct.unpack("<ii", self._recv(conn, 8))
                        self.frame = np.zeros((h, w, 3), np.float32)
                    elif cmd == 1:  # PIXEL
                        (n,) = struct.unpack("<i", self._recv(conn, 4))
                        px = np.frombuffer(self._recv(conn, 20 * n),
                                           "<f4").reshape(n, 5)
                        xs, ys = px[:, 0].astype(int), px[:, 1].astype(int)
                        self.frame[ys, xs] = px[:, 2:5]
                    elif cmd == 2:  # FINISH
                        self.finished = True
                        return
                    else:
                        raise ValueError(f"unknown command {cmd}")
        except Exception as e:  # reported by join()
            self.error = e
        finally:
            self.srv.close()

    def join(self, timeout: float = 120.0) -> "SocketListener":
        self.thread.join(timeout)
        if self.thread.is_alive() or self.error is not None:
            raise AssertionError(f"socket listener: {self.error or 'timeout'}")
        return self


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from lucille_tpu_torch.accel import ao, bvh_ao, bvh_isect, isect, ugrid

    return {"closest_hit": isect.COUNTS, "any_hit": isect.ANY_COUNTS,
            "ao_occlusion": ao.COUNTS, "ao_occlusion_bits": ao.BITS_COUNTS,
            "bvh_closest_hit": bvh_isect.CLOSEST_COUNTS,
            "bvh_any_hit": bvh_isect.ANY_COUNTS,
            "bvh_ao_fused": bvh_ao.FUSED_COUNTS,
            "grid_closest_hit": ugrid.COUNTS,
            "grid_any_hit": ugrid.ANY_COUNTS,
            "sky_gather": ao.SKY_COUNTS}


# each wrapper counter's __global__ function (csrc/*.cu)
KERNELS = {"closest_hit": "closest_hit_kernel", "any_hit": "any_hit_kernel",
           "ao_occlusion": "ao_kernel", "ao_occlusion_bits": "ao_kernel",
           "bvh_closest_hit": "bvh_closest_kernel",
           "bvh_any_hit": "bvh_any_kernel", "bvh_ao_fused": "bvh_ao_kernel",
           "grid_closest_hit": "grid_kernel", "grid_any_hit": "grid_kernel",
           "sky_gather": "sky_gather_kernel"}


def by_kernel(launches: dict) -> dict:
    """Wrapper counts {counter name: n} summed by __global__ function."""
    out = dict.fromkeys(sorted(set(KERNELS.values())), 0)
    for name, n in launches.items():
        out[KERNELS[name]] += n
    return out


def traced_launches(prof) -> dict:
    """{__global__ function: launches} of the hand-written kernels among
    the device events of a torch.profiler run (a graph's replay
    included: its kernels are traced one by one)."""
    from torch.autograd import DeviceType

    names = sorted(set(KERNELS.values()))
    pattern = re.compile(rf"\b({'|'.join(names)})\s*[<(]")
    out = dict.fromkeys(names, 0)
    for e in prof.events():
        m = e.device_type == DeviceType.CUDA and pattern.search(e.name)
        if m:
            out[m.group(1)] += 1
    return out


@contextmanager
def environ(**changes):
    """os.environ with `changes` applied inside the block (a value of None
    unsets the variable), restored after."""
    saved = {k: os.environ.get(k) for k in changes}
    for k, v in changes.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bvh_ao_mode(mode: str):
    """LUCILLE_BVH_AO set to `mode` inside the block (the tile BVH's
    gathers read it at call time), restored after."""
    return environ(LUCILLE_BVH_AO=mode)


@contextmanager
def no_host_sync(r):
    """Inside the block every tile Renderer r enqueues runs under torch's
    sync debug mode "error": a tile that makes the host wait for the card
    (a host-to-device copy, .item(), a boolean mask index) raises.  The
    pulls of finished tiles lie outside the tiles and are not checked."""
    import torch

    tile = r._tile

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return tile(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    r._tile = strict
    try:
        yield
    finally:
        del r._tile


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


def hit_kernel_ms(fn, kernel: str) -> tuple[float, float]:
    """(device ms of kernel 1, 2 or 4 in a call of fn, from the profiler
    as profile_gather.py reads it; ms a call on CUDA events, the
    wrapper's host work included).  These kernels take less device time
    than their wrappers take on the host, so events around back-to-back
    calls time the host."""
    from profile_gather import kernel_ms

    return kernel_ms(fn, kernel)[0], cuda_ms(fn, 10)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def tiles_reached(boxes, org, dirn, tmax):
    """(B, n_tiles) bool: the ray reaches the tile's box before tmax (the
    kernels' slab test).  A tile of padding alone (an empty box, min +inf
    and max -inf) is never reached: no ray needs it."""
    import torch

    inv = 1.0 / torch.where(dirn.abs() > 1e-20, dirn, 1e-20)
    lo = (boxes[0:3].T[None] - org[:, None]) * inv[:, None]
    hi = (boxes[3:6].T[None] - org[:, None]) * inv[:, None]
    tn = torch.minimum(lo, hi).amax(dim=-1)
    tf = torch.maximum(lo, hi).amin(dim=-1)
    filled = (boxes[0:3] <= boxes[3:6]).all(dim=0)[None]
    return filled & (tn <= tf) & (tf > 0) & (tn < tmax[:, None])


def reached_sums(boxes, weights, org, dirn, tmax):
    """[(B,) i64 for each (n_box,) row of weights]: per ray the row's sum
    over the boxes the ray reaches before its tmax, by tiles_reached's
    slab test; rays in chunks of a few million (ray, box) pairs."""
    import torch

    n_box = boxes.shape[1]
    step = max(1, (1 << 22) // max(n_box, 1))
    sums = [[] for _ in weights]
    for lo in range(0, org.shape[0], step):
        reach = tiles_reached(boxes, org[lo:lo + step], dirn[lo:lo + step],
                              tmax[lo:lo + step])
        for acc, w in zip(sums, weights):
            acc.append((reach * w).sum(dim=1))
    return [torch.cat(acc) for acc in sums]


def dense_need(scene, org, dirn, t_end, live=None, occluded=None) -> dict:
    """The dense kernels' needed work at the grain of the scene's boxes,
    per live ray before t_end (closest hit: just past its hit; any-hit:
    its tmax): "groups", the real triangles of the 8-triangle groups it
    reaches (coarser, "tiles": of the tiles it reaches); "slabs", its box
    tests: the box of every real supertile, of each real tile in a
    supertile it reaches and of each real group in a tile it reaches.  An
    occluded ray needs 1 triangle test and 3 box tests (its occluder and
    the boxes around it, found first at best).  Returns Python ints."""
    import torch

    from lucille_tpu_torch.accel.pack import SUB, SUPER, TC

    n_tris = scene.n_tris
    n_tiles, n_groups = -(-n_tris // TC), -(-n_tris // SUB)
    n_super = -(-n_tiles // SUPER)

    def members(n_box, size, total):  # each box's share of total
        idx = torch.arange(n_box, device=org.device)
        return (total - idx * size).clamp(0, size)

    tris_in_tile = members(n_tiles, TC, n_tris)
    groups, = reached_sums(scene.sub_boxes[:, :n_groups],
                           [members(n_groups, SUB, n_tris)], org, dirn, t_end)
    tiles, group_boxes = reached_sums(
        scene.boxes[:, :n_tiles], [tris_in_tile, -(-tris_in_tile // SUB)],
        org, dirn, t_end)
    tile_boxes, = reached_sums(scene.sboxes[:, :n_super],
                               [members(n_super, SUPER, n_tiles)], org, dirn,
                               t_end)
    need = {"groups": groups, "tiles": tiles,
            "slabs": n_super + tile_boxes + group_boxes}
    for key, n in need.items():
        if live is not None:
            n = n * live
        if occluded is not None:
            n = torch.where(occluded, 3 if key == "slabs" else 1, n)
        need[key] = int(n.sum())
    return need


def dense_bound(scene, B: int, ray_bytes: int, need) -> dict:
    """bound() of a dense kernel on B rays of ray_bytes each: the packs
    read once (36 bytes a triangle slot, 32 a box of each level) and
    dense_need's triangle and box tests."""
    n_boxes = sum(b.shape[1] for b in (scene.boxes, scene.sboxes,
                                       scene.sub_boxes))
    return bound(B * ray_bytes + scene.n_pad * 36 + n_boxes * 32,
                 need["groups"] * MT_OPS + need["slabs"] * SLAB_OPS)


def dense_work(res, need) -> dict:
    """The dense walk's counters (isect.walk_stats) against dense_need's.
    Returns {"text", "numbers"}."""
    k = {key: int(res[key]) for key in ("ntrav", "ntests", "warp_ntrav",
                                        "warp_ntests")}
    simt = k["ntests"] / max(32 * k["warp_ntests"], 1)
    text = (f"{k['ntests']} lane triangle tests done, "
            f"{k['ntests'] / max(need['groups'], 1):.2f}x the "
            f"{need['groups']} needed at group grain ({need['tiles']} at "
            f"tile grain); {k['ntrav']} lane group visits, "
            f"{k['warp_ntrav']} warp group visits and {k['warp_ntests']} "
            f"warp triangle steps (SIMT efficiency {simt:.3f})")
    return {"text": text, "numbers": {
        **{f"kernel_{key}": v for key, v in k.items()},
        "simt_efficiency": simt,
        **{f"need_{key}": v for key, v in need.items()}}}


def gather_work(res, need) -> dict:
    """The dense AO gather's counters (accel.ao.gather_stats) against
    gather_need's count.  Returns {"text", "numbers"}."""
    k = {key: int(res[key]) for key in ("super_tests", "tile_tests",
                                        "quarter_tests", "group_tests",
                                        "setups", "tests", "warp_steps")}
    simt = k["tests"] / max(32 * k["warp_steps"], 1)
    text = (f"{k['tests']} lane stratum-triangle tests, "
            f"{k['tests'] / max(need['tests'], 1):.3f}x the "
            f"{need['tests']} needed; {k['group_tests']} group and "
            f"{k['tile_tests']} tile box tests ({need['groups']} / "
            f"{need['tiles']} needed), {k['super_tests']} supertile and "
            f"{k['quarter_tests']} quarter-tile box tests; {k['setups']} "
            f"triangle set-ups "
            f"({k['tests'] / max(k['setups'], 1):.2f} tests each); "
            f"{k['warp_steps']} warp test steps (SIMT efficiency "
            f"{simt:.3f})")
    return {"text": text, "numbers": {
        **{f"kernel_{key}": v for key, v in k.items()},
        "simt_efficiency": simt,
        **{f"need_{key}": need[key] for key in ("tiles", "groups",
                                               "tests")}}}


def poisoned(scene, p, w, size):
    """A copy of the dense scene whose pad slots hold one triangle of
    side ~3 size through point p, normal to w; its boxes and n_tris are
    left as they are, so a kernel that tests a pad slot meets it."""
    import dataclasses

    import torch

    w = torch.nn.functional.normalize(w, dim=0)
    a = torch.linalg.cross(w, torch.tensor([0.0, 0.0, 1.0], device=w.device))
    if float(a.norm()) < 0.1:
        a = torch.linalg.cross(w, torch.tensor([1.0, 0.0, 0.0],
                                               device=w.device))
    a = torch.nn.functional.normalize(a, dim=0)
    b = torch.linalg.cross(w, a)
    tri = torch.cat([p - size * (a + b), 3 * size * a, 3 * size * b])
    tris = scene.tris.clone()
    tris[:9, scene.n_tris:] = tri[:, None]
    return dataclasses.replace(scene, tris=tris)


def occ_poisoned(scene):
    """A copy of the dense scene whose occlusion pack's pad slots hold the
    12 faces of a box 1% larger than the scene's bounds, repeated: every
    stratum of every lane on the scene meets one.  Its boxes and n_tris
    are left as they are, so a gather that tests a pad slot meets it."""
    import dataclasses

    import torch

    pad = scene.occ.shape[1] - scene.n_tris
    if pad < 12:
        raise AssertionError(f"{pad} pad slots: too few for a box")
    ext = scene.bbox_max - scene.bbox_min
    lo, hi = scene.bbox_min - 0.01 * ext, scene.bbox_max + 0.01 * ext
    tris = []
    for ax in range(3):
        a, b = (ax + 1) % 3, (ax + 2) % 3
        for side in (lo[ax], hi[ax]):
            def corner(u, w):
                p = torch.empty(3, device=lo.device)
                p[ax], p[a], p[b] = side, u, w
                return p
            p00, p10 = corner(lo[a], lo[b]), corner(hi[a], lo[b])
            p11, p01 = corner(hi[a], hi[b]), corner(lo[a], hi[b])
            tris += [(p00, p10, p11), (p00, p11, p01)]
    rows = torch.stack([torch.cat([v0, v1, v2, torch.linalg.cross(
        v1 - v0, v2 - v0)]) for v0, v1, v2 in tris], dim=1)  # (12, 12)
    occ = scene.occ.clone()
    occ[:12, scene.n_tris:] = rows.repeat(1, -(-pad // 12))[:, :pad]
    return dataclasses.replace(scene, occ=occ)


def check_padding_untouched(label, scene, org, dirn, P_off, wi, hit,
                            n_slice) -> None:
    """The kernels never test a pad slot: on a copy of the scene whose pad
    slots hold a triangle that every eye ray meets first (just in front
    of the camera, normal to the tile's mean direction) and every sun ray
    meets (beyond the scene, normal to the sun), both kernels answer
    exactly as on the scene; the twins, which test every slot, meet it on
    a slice."""
    import torch

    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.accel.pack import TC

    diag = float(torch.linalg.norm(scene.bbox_max - scene.bbox_min))
    w_eye = dirn.mean(dim=0)
    eye = poisoned(scene, org[0] + 0.01 * diag * torch.nn.functional.normalize(
        w_eye, dim=0), w_eye, 10 * diag)
    center = 0.5 * (scene.bbox_max + scene.bbox_min)
    sun = poisoned(scene, center + 2 * diag * wi[0], wi[0], 10 * diag)
    inf = torch.full((org.shape[0],), float("inf"), device="cuda")
    a = isect.closest_hit_kernel(scene, org, dirn)
    b = isect.closest_hit_kernel(eye, org, dirn)
    oa = isect.any_hit_kernel(scene, P_off, wi, inf, hit)["occ"]
    ob = isect.any_hit_kernel(sun, P_off, wi, inf, hit)["occ"]
    sl = slice(0, n_slice)
    lit = torch.nonzero(hit)[:n_slice, 0]
    twin_eye = isect.closest_hit_reference(eye.tris, org[sl], dirn[sl])
    twin_sun = isect.any_hit_reference(sun.tris, P_off[lit], wi[lit],
                                       inf[lit])["occ"]
    met = ((twin_eye["tri"] >= scene.n_tris).float().mean().item(),
           twin_sun.float().mean().item())
    same = all(torch.equal(a[k], b[k]) for k in ("t", "u", "v", "tri")) and (
        torch.equal(oa, ob))
    empty = scene.n_pad // TC - -(-scene.n_tris // TC)
    print(f"[{label}] padding: {scene.n_pad - scene.n_tris} pad slots past "
          f"triangle {scene.n_tris} ({empty} tile{'s' * (empty != 1)} of "
          f"padding alone) hold a triangle the twins meet on "
          f"{met[0]:.4f} of the eye rays and {met[1]:.4f} of the live sun "
          f"rays; both kernels' answers {'unchanged' if same else 'CHANGED'}"
          f": no pad slot tested", flush=True)
    if not same or not all(m >= 0.9 for m in met):
        raise AssertionError(f"{label}: a kernel tested a pad slot, or the "
                             f"poison is not met ({met})")


def gather_need(scene, P_off, b0, b1, b2, u01, ntheta: int, nphi: int,
                budget: int = 1 << 24) -> dict:
    """The work the dense AO gather needs on hit lanes P_off, b0, b1, b2
    (n, 3) with uniforms u01 (2, n) at ntheta x nphi strata, counted at
    the grain csrc/ao.cu proves is enough: each stratum's ray walks the
    scene's real triangles in slot order, up to and including its first
    occluder (all of them when it is open); it tests the box of each tile
    it reaches, the box of each SUB-triangle group that holds a real
    triangle in a tile it reaches, and each real triangle of a group whose
    box it reaches.  Works on about `budget` (ray, group) pairs at a time.
    Returns {"tiles", "groups", "tests": those counts (Python ints),
    "occluded": (S, n) bool, the strata that have an occluder}."""
    import torch

    from lucille_tpu_torch.accel.ao import stratum_directions
    from lucille_tpu_torch.accel.isect import DET_EPS
    from lucille_tpu_torch.accel.pack import SUB, TC

    n, S, n_tris = P_off.shape[0], ntheta * nphi, scene.n_tris
    n_real, n_groups = -(-n_tris // TC), -(-n_tris // SUB)
    dev = P_off.device
    occ = scene.occ[:, :n_tris]
    tile_of = torch.arange(n_groups, device=dev) // (TC // SUB)
    k = torch.arange(n_real, device=dev)
    g_lo = k * (TC // SUB)
    g_hi = torch.clamp_max(g_lo + TC // SUB - 1, n_groups - 1)
    in_group = torch.arange(SUB, device=dev)
    none = scene.n_pad  # past every slot: an open stratum walks them all
    tiles = groups = tests = 0
    occluded = torch.zeros((S, n), dtype=torch.bool, device=dev)
    step = max(1, budget // (S * max(n_groups, 1)))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        d = stratum_directions(b0[lo:hi], b1[lo:hi], b2[lo:hi], u01[:, lo:hi],
                               ntheta, nphi).reshape(-1, 3)  # row s * m + l
        o = P_off[lo:hi].repeat(S, 1)
        far = torch.full((o.shape[0],), float("inf"), device=dev)
        t_reach = tiles_reached(scene.boxes[:, :n_real], o, d, far)
        g_reach = tiles_reached(scene.sub_boxes[:, :n_groups], o, d,
                                far) & t_reach[:, tile_of]
        ray, grp = torch.nonzero(g_reach, as_tuple=True)
        j = grp[:, None] * SUB + in_group  # (pairs, SUB) slots
        real = j < n_tris
        col = occ[:, torch.clamp_max(j, n_tris - 1)]  # (16, pairs, SUB)
        ox, oy, oz = (o[ray, c][:, None] for c in range(3))
        wx, wy, wz = (d[ray, c][:, None] for c in range(3))
        pax, pay, paz = col[0] - ox, col[1] - oy, col[2] - oz
        pbx, pby, pbz = col[3] - ox, col[4] - oy, col[5] - oz
        pcx, pcy, pcz = col[6] - ox, col[7] - oy, col[8] - oz
        nx, ny, nz = col[9], col[10], col[11]
        U = (wx * (pby * pcz - pbz * pcy) + wy * (pbz * pcx - pbx * pcz)
             + wz * (pbx * pcy - pby * pcx))
        V = (wx * (pcy * paz - pcz * pay) + wy * (pcz * pax - pcx * paz)
             + wz * (pcx * pay - pcy * pax))
        dn = wx * nx + wy * ny + wz * nz
        W = dn - U - V
        s_n = pax * nx + pay * ny + paz * nz
        hit = (real & ((torch.minimum(torch.minimum(U, V), W) >= 0.0)
                       | (torch.maximum(torch.maximum(U, V), W) <= 0.0))
               & (s_n * dn > 0.0) & (dn.abs() > DET_EPS))
        first = torch.full((o.shape[0],), none, dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, ray, torch.where(hit, j, none).amin(dim=1), "amin")
        tests += int((real & (j <= first[ray][:, None])).sum())
        last_g = torch.clamp_max(first // SUB, n_groups - 1)[:, None]
        per_tile = torch.clamp_min(torch.minimum(last_g, g_hi) - g_lo + 1, 0)
        groups += int((per_tile * t_reach).sum())
        tiles += int((t_reach & (k <= (first // TC)[:, None])).sum())
        occluded[:, lo:hi] = (first < none).reshape(S, hi - lo)
    return {"tiles": tiles, "groups": groups, "tests": tests,
            "occluded": occluded}


def gather_walk(scene, rays, u01, n_live: int, ntheta: int,
                nphi: int) -> dict:
    """csrc/ao.cu's counters, in plain torch, for the launch
    accel.ao.ao_occlusion_kernel makes on compacted lanes `rays` (12, B)
    with uniforms u01 (2, B), the first n_live live: every thread (lane,
    chunk of C strata; warps and rounds as accel.ao.gather_layout lays
    them out) walks as the kernel does.  A stratum meets each supertile
    while pending and above its lane's tangent plane (a supertile box
    test), each tile of a supertile its ray reaches while pending and
    above the plane (a tile box test), each quarter of a tile it reaches
    while pending (32 slots, the union of four group boxes: a quarter box
    test), each group of a quarter it reaches while pending (a group box
    test), and each triangle of a group it reaches up to its first
    occluder (a test); the triangles go four at a time (a quad: slots 4q
    .. 4q + 3 of the real ones), a thread sets a quad's triangles up when
    one of its strata is pending there, and a warp's test steps over a
    quad are the most such strata of one of its threads times the quad's
    triangles.  Tests every (stratum, triangle) pair: small shapes only.
    Returns Python ints under accel.ao.gather_stats' keys, and
    "occluded" (S, n_live) bool."""
    import torch

    from lucille_tpu_torch.accel.ao import (
        AO_BLOCK,
        gather_layout,
        stratum_directions,
    )
    from lucille_tpu_torch.accel.isect import DET_EPS
    from lucille_tpu_torch.accel.pack import SUB, SUPER, TC

    B, S, n, n_tris = rays.shape[1], ntheta * nphi, n_live, scene.n_tris
    dev = rays.device
    n_real, n_groups = -(-n_tris // TC), -(-n_tris // SUB)
    n_sup = -(-n_real // SUPER)
    o, nrm = rays[0:3, :n].T, rays[9:12, :n].T
    d = stratum_directions(rays[3:6, :n].T, rays[6:9, :n].T, nrm, u01[:, :n],
                           ntheta, nphi)  # (S, n, 3)

    def below(boxes, m):  # (n, m): box wholly below the lane's plane
        c = [torch.where(nrm[:, a:a + 1] > 0, boxes[3 + a, :m][None],
                         boxes[a, :m][None]) for a in range(3)]
        dot = ((c[0] - o[:, 0:1]) * nrm[:, 0:1]
               + (c[1] - o[:, 1:2]) * nrm[:, 1:2]
               + (c[2] - o[:, 2:3]) * nrm[:, 2:3])
        return ~(dot >= 0)

    def reached(boxes, m):  # (S, n, m)
        inf = torch.full((S * n,), float("inf"), device=dev)
        return tiles_reached(boxes[:, :m], o.repeat(S, 1), d.reshape(-1, 3),
                             inf).reshape(S, n, m)

    j = torch.arange(n_tris, device=dev)
    tile_of, sup_of = j // TC, j // (SUPER * TC)
    open_s = ~below(scene.sboxes, n_sup)  # (n, n_sup)
    open_t = ~below(scene.boxes, n_real)
    in_s = open_s[None] & reached(scene.sboxes, n_sup)  # (S, n, n_sup)
    in_t = (in_s[:, :, torch.arange(n_real, device=dev) // SUPER]
            & open_t[None] & reached(scene.boxes, n_real))
    n_quart = -(-n_tris // (4 * SUB))
    g4 = scene.sub_boxes[:6, :4 * n_quart].reshape(6, n_quart, 4)
    in_q = (in_t[:, :, torch.arange(n_quart, device=dev) // (TC // SUB // 4)]
            & reached(torch.cat([g4[:3].amin(dim=2), g4[3:].amax(dim=2)]),
                      n_quart))
    in_g = (in_q[:, :, torch.arange(n_groups, device=dev) // 4]
            & reached(scene.sub_boxes, n_groups))
    reach = in_g[:, :, j // SUB]  # (S, n, n_tris): tested unless occluded
    occ = scene.occ[:, :n_tris]
    hit = torch.zeros_like(reach)
    for s in range(S):  # the twin's signed-volume test, its order
        ox, oy, oz = (o[:, c:c + 1] for c in range(3))
        wx, wy, wz = (d[s, :, c:c + 1] for c in range(3))
        pax, pay, paz = occ[0][None] - ox, occ[1][None] - oy, occ[2][None] - oz
        pbx, pby, pbz = occ[3][None] - ox, occ[4][None] - oy, occ[5][None] - oz
        pcx, pcy, pcz = occ[6][None] - ox, occ[7][None] - oy, occ[8][None] - oz
        nx, ny, nz = occ[9][None], occ[10][None], occ[11][None]
        U = (wx * (pby * pcz - pbz * pcy) + wy * (pbz * pcx - pbx * pcz)
             + wz * (pbx * pcy - pby * pcx))
        V = (wx * (pcy * paz - pcz * pay) + wy * (pcz * pax - pcx * paz)
             + wz * (pcx * pay - pcy * pax))
        dn = wx * nx + wy * ny + wz * nz
        W = dn - U - V
        s_n = pax * nx + pay * ny + paz * nz
        hit[s] = (((torch.minimum(torch.minimum(U, V), W) >= 0)
                   | (torch.maximum(torch.maximum(U, V), W) <= 0))
                  & (s_n * dn > 0) & (dn.abs() > DET_EPS))
    none = scene.n_pad
    first = torch.where(hit & reach, j, none).amin(dim=2,
                                                  keepdim=True)  # (S, n, 1)
    k_s = torch.arange(n_sup, device=dev) * (SUPER * TC)
    k_t = torch.arange(n_real, device=dev) * TC
    k_q = torch.arange(n_quart, device=dev) * (4 * SUB)
    k_g = torch.arange(n_groups, device=dev) * SUB
    tested = reach & (j <= first)
    quad = j - j % 4
    enters = reach & (quad <= first)  # the stratum meets the quad
    counts = {
        "super_tests": (open_s[None] & (first >= k_s)).sum(),
        "tile_tests": (in_s[:, :, torch.arange(n_real, device=dev) // SUPER]
                       & open_t[None] & (first >= k_t)).sum(),
        "quarter_tests": (in_t[:, :, torch.arange(n_quart, device=dev)
                               // (TC // SUB // 4)] & (first >= k_q)).sum(),
        "group_tests": (in_q[:, :, torch.arange(n_groups, device=dev) // 4]
                        & (first >= k_g)).sum(),
        "tests": tested.sum()}
    # threads: chunks of C strata; a warp holds 32 consecutive thread ids
    C, T, grid = gather_layout(S, B)
    n_chunks, lanes = -(-S // C), AO_BLOCK // T
    per = torch.zeros((n_chunks * C, n, n_tris), dtype=torch.int32,
                      device=dev)
    per[:S] = enters[:, :, quad].to(torch.int32)  # at the quad's first slot
    per = per.reshape(n_chunks, C, n, n_tris).sum(dim=1)  # (chunk, lane, j)
    counts["setups"] = (per > 0).sum()
    gt = torch.arange(grid * AO_BLOCK, device=dev)
    lane = gt // AO_BLOCK * lanes + gt % AO_BLOCK % lanes
    t = gt % AO_BLOCK // lanes
    steps = 0
    for r in range(-(-n_chunks // T)):
        chunk = r * T + t
        ok = (lane < n) & (chunk < n_chunks)
        rows = per[chunk[ok], lane[ok]]  # (threads, n_tris)
        warp = (gt[ok] // 32)[:, None].expand_as(rows)
        most = torch.zeros((grid * AO_BLOCK // 32, n_tris), dtype=rows.dtype,
                           device=dev).scatter_reduce(0, warp, rows, "amax")
        steps += int(most.sum())
    counts = {k: int(v) for k, v in counts.items()}
    counts["warp_steps"] = steps
    counts["occluded"] = (first[:, :, 0] < none)
    return counts


def need_walk(tris, nodes, org, dirn, closest: bool, depth: int,
              chunk: int = 16384, tmax=None) -> dict:
    """The tile-BVH work rays org, dirn (R, 3) need, counted by walking
    the tree in plain torch: each ray enters the root, at an inner node
    tests both child boxes and enters the near child first (the one on
    the low side of the split axis when the ray's direction along it is
    >= 0), skipping a child it does not reach (the closest hit: whose
    entry is not before its best t), as csrc/bvh.cu's kernels 4 and 5
    walk; a leaf tests its real triangles in slot order (padding slots,
    all zero, are no work), the any-hit (unbounded signed-volume test)
    up to its first hit and then stopping, the closest hit
    (Moller-Trumbore, 0 < t < best t, which starts at tmax (R,), None:
    unbounded) every one, a leaf's least t, the lowest slot on equal t,
    replacing the best only if nearer.  Returns {"hit" (R,) bool (hit or
    occluded), "t" (R,) the closest hit's best t (tmax on a miss), "tri"
    (R,) its slot (-1 on a miss), "inner" inner nodes entered, "nodes"
    nodes entered, "tests" real triangles tested, "distinct_nodes" the
    nodes some ray entered, "leaf_tris" the real triangles of the leaves
    some ray entered (Python ints)}."""
    import torch

    from lucille_tpu_torch.accel.pack import TC

    R, dev = org.shape[0], org.device
    inf = float("inf")
    ints = nodes.view(torch.int32)
    meta, link = ints[:, 3].long(), ints[:, 7].long()
    lo, hi = nodes[:, 0:3], nodes[:, 4:7]
    real = (tris[0:9] != 0).any(dim=0)
    L = int(meta.max()) * TC
    lane = torch.arange(L, device=dev)
    inv = 1.0 / torch.where(dirn.abs() > 1e-20, dirn,
                            torch.full_like(dirn, 1e-20))

    def slab(n, rows):
        t0 = (lo[n] - org[rows]) * inv[rows]
        t1 = (hi[n] - org[rows]) * inv[rows]
        return (torch.minimum(t0, t1).amax(dim=1),
                torch.maximum(t0, t1).amin(dim=1))

    cur = torch.zeros(R, dtype=torch.long, device=dev)
    sp = torch.zeros(R, dtype=torch.long, device=dev)
    stack = torch.zeros((R, depth + 1), dtype=torch.long, device=dev)
    stack_tn = torch.zeros((R, depth + 1), device=dev)
    t_best = (torch.full((R,), inf, device=dev) if tmax is None
              else tmax.to(torch.float32).clone())
    tri = torch.full((R,), -1, dtype=torch.long, device=dev)
    hit = torch.zeros(R, dtype=torch.bool, device=dev)
    entered = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
    n_inner = n_nodes = 0
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        idx = torch.nonzero(cur >= 0)[:, 0]
        if idx.numel() == 0:
            break
        n_nodes += idx.numel()
        c = cur[idx]
        entered[c] = True
        m = meta[c]
        leaf = m > 0
        nxt = torch.full_like(c, -1)

        # inner nodes: both child boxes, the near child first
        inner = ~leaf
        ii, ci = idx[inner], c[inner]
        n_inner += ii.numel()
        c0, c1 = ci + 1, link[ci]
        tn0, tf0 = slab(c0, ii)
        tn1, tf1 = slab(c1, ii)
        bound = t_best[ii] if closest else inf
        r0 = (tn0 <= tf0) & (tf0 > 0) & (tn0 < bound)
        r1 = (tn1 <= tf1) & (tf1 > 0) & (tn1 < bound)
        near0 = dirn[ii, -m[inner] - 1] >= 0
        near = torch.where(near0, c0, c1)
        far = torch.where(near0, c1, c0)
        rn = torch.where(near0, r0, r1)
        rf = torch.where(near0, r1, r0)
        push = rn & rf
        pi = ii[push]
        stack[pi, sp[pi]] = far[push]
        stack_tn[pi, sp[pi]] = torch.where(near0, tn1, tn0)[push]
        sp[pi] += 1
        nxt[inner] = torch.where(rn, near, torch.where(rf, far, -1))

        # leaves: the real triangles in slot order
        li, cl = idx[leaf], c[leaf]
        first, count = link[cl] * TC, m[leaf] * TC
        stop = torch.zeros(li.numel(), dtype=torch.bool, device=dev)
        for a in range(0, li.numel(), chunk):
            rows = li[a : a + chunk]
            inleaf = lane[None] < count[a : a + chunk, None]
            k = torch.where(inleaf, first[a : a + chunk, None] + lane[None], 0)
            rv = inleaf & real[k]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tris[r][k] for r in range(9))
            ox, oy, oz = (org[rows, i : i + 1] for i in range(3))
            dx, dy, dz = (dirn[rows, i : i + 1] for i in range(3))
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            u = sx * px + sy * py + sz * pz
            v = qx * dx + qy * dy + qz * dz
            t = e2x * qx + e2y * qy + e2z * qz
            if closest:
                valid = det.abs() > 1e-14
                inva = torch.where(valid, 1.0 / torch.where(valid, det, 1.0),
                                   0.0)
                u, v, t = u * inva, v * inva, t * inva
                h = (valid & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                     & (t > 0) & (t < t_best[rows, None]) & rv)
                tc, j = torch.where(h, t, inf).min(dim=1)  # first of equals
                better = h.any(dim=1)
                t_best[rows] = torch.where(better, tc, t_best[rows])
                tri[rows] = torch.where(better, k.gather(1, j[:, None])[:, 0],
                                        tri[rows])
                hit[rows] |= better
                tests += rv.sum()
            else:
                w = det - u - v
                inside = ((torch.minimum(torch.minimum(u, v), w) >= 0)
                          | (torch.maximum(torch.maximum(u, v), w) <= 0))
                h = inside & (t * det > 0) & (det.abs() > 1e-14) & rv
                anyh = h.any(dim=1)
                upto = torch.cumsum(rv, dim=1).gather(
                    1, h.to(torch.int8).argmax(dim=1, keepdim=True))[:, 0]
                tests += torch.where(anyh, upto, rv.sum(dim=1)).sum()
                hit[rows] = anyh
                stop[a : a + chunk] = anyh
        nxt[leaf] = torch.where(stop, -2, -1)  # -2: occluded, walk ends
        cur[idx] = nxt

        # pop: the closest hit only a child still nearer than its best t
        while True:
            pi = torch.nonzero((cur == -1) & (sp > 0))[:, 0]
            if pi.numel() == 0:
                break
            sp[pi] -= 1
            cand = stack[pi, sp[pi]]
            if closest:
                cand = torch.where(stack_tn[pi, sp[pi]] < t_best[pi], cand, -1)
            cur[pi] = cand
    leaves = torch.nonzero(entered & (meta > 0))[:, 0]
    per_tile = torch.cumsum(
        torch.cat([real.new_zeros(1, dtype=torch.long),
                   real.view(-1, TC).sum(dim=1)]), dim=0)
    leaf_tris = per_tile[link[leaves] + meta[leaves]] - per_tile[link[leaves]]
    return {"hit": hit, "t": t_best, "tri": tri, "inner": n_inner,
            "nodes": n_nodes, "tests": int(tests),
            "distinct_nodes": int(entered.sum()),
            "leaf_tris": int(leaf_tris.sum())}


def compare_closest(got, ref, sl, name, tri_tol=1e-4):
    """A closest hit's answers on slice sl against its twin's: tri differs
    on at most tri_tol of the slice, t/u/v within 1e-6 relative where the
    two agree.  Returns (max |t, u, v error|, fraction tri differs)."""
    import torch

    tri_k, tri_r = got["tri"][sl], ref["tri"]
    differ = (tri_k != tri_r).float().mean().item()
    same = (tri_k == tri_r) & (tri_r >= 0)
    err = 0.0
    for k in ("t", "u", "v"):
        a, b = got[k][sl][same], ref[k][same]
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        err = max(err, (a - b).abs().max().item() if len(a) else 0.0)
    if differ > tri_tol or not same.any():
        raise AssertionError(f"{name}: tri differs on {differ:.2e} of the "
                             "slice, or nothing hit")
    return err, differ


def check_kernels(label, desc, tile, n_slice, results):
    """Phase 3 for one scene: the dense kernels on the scene's first tile
    against their plain twins.  Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.accel.pack import TC
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
    n_tiles = scene.n_pad // TC
    print(f"[{label}] {scene.n_tris} triangles, {n_tiles} tiles, tile "
          f"({x0},{y0}) {tile}x{tile}x{xs * ys} = {B} eye rays, "
          f"slice {n_slice}", flush=True)

    # -- the closest hit
    got = isect.closest_hit_kernel(scene, org, dirn)
    ref = isect.closest_hit_reference(scene.tris, org[sl], dirn[sl])
    torch.cuda.synchronize()
    err, differ = compare_closest(got, ref, sl, "closest_hit")
    ms, call_ms = hit_kernel_ms(
        lambda: isect.closest_hit_kernel(scene, org, dirn), "closest_hit")
    plain_ms = cuda_ms(lambda: isect.closest_hit_reference(scene.tris, org,
                                                           dirn), 1)
    hit_rate = (got["tri"] >= 0).float().mean().item()
    # the work this data needs: the real triangles of every group a ray
    # reaches before its closest hit
    inf = torch.full((B,), float("inf"), device="cuda")
    t_end = torch.where(got["tri"] >= 0, torch.nextafter(got["t"], inf), inf)
    need = dense_need(scene, org, dirn, t_end)
    work = dense_bound(scene, B, 24 + 16, need)
    walk = dense_work(got, need)
    print(f"[{label}] closest_hit: hit rate {hit_rate:.4f}, tri differs on "
          f"{differ:.2e} of the slice, max |t,u,v err| {err:.3e}; kernel "
          f"{ms:.3f} ms ({call_ms:.3f} ms a call), plain {plain_ms:.3f} ms, "
          f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}); "
          f"{walk['text']}", flush=True)
    results["closest_hit"].append(
        {"scene": label, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
         "plain_ms": plain_ms, **walk["numbers"], **work})

    # -- the AO gather, 8x8 strata, the jitter of the whole tile
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    jitter = r.sampler(x0, y0).uniform((), (2, B))
    check_gather(label, scene, (P_off, b0, b1, b2, hit, jitter), 8, 8,
                 n_slice, results)

    # -- the any-hit: the hit lanes' shadow rays toward the scene's sun
    sun = next(li for li in r.lights if li.type == "sun")
    wi = torch.tensor(sun.direction, dtype=torch.float32, device="cuda")
    wi = (wi / torch.sqrt(torch.sum(wi * wi))).expand_as(P_off).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(3)
    diag = float(torch.linalg.norm(scene.bbox_max - scene.bbox_min))
    finite = diag * torch.rand(B, device="cuda", generator=gen)
    cases = [("", None, inf, hit)]
    if label == "bundled":
        cases.append((", finite tmax", finite, finite, hit))
    worst, entry = 0.0, None
    for what, tmax_arg, tmax, active in cases:
        res = isect.any_hit(scene, P_off, wi, tmax_arg, active,
                            counters=True)
        got = res["occ"]
        ref = isect.any_hit_reference(scene.tris, P_off[sl], wi[sl], tmax[sl],
                                      active[sl])["occ"]
        torch.cuda.synchronize()
        frac = (got[sl] != ref).float().mean().item()
        if frac > 1e-4:
            raise AssertionError(f"any_hit{what}: {frac:.2e} of rays differ")
        # a kernel that always answers one way must not pass
        slice_occ = ref[active[sl]].float().mean().item()
        if not 0.01 < slice_occ < 0.99:
            raise AssertionError(f"any_hit{what}: the slice's live rays are "
                                 f"{slice_occ:.4f} occluded")
        if torch.any(got[~active]):
            raise AssertionError("any_hit: a dead ray reports occlusion")
        worst = max(worst, frac)
        ms, call_ms = hit_kernel_ms(lambda: isect.any_hit(
            scene, P_off, wi, tmax_arg, active), "any_hit")
        plain_ms = cuda_ms(lambda: isect.any_hit_reference(
            scene.tris, P_off, wi, tmax, active), 1)
        need = dense_need(scene, P_off, wi, tmax, active, got)
        work = dense_bound(scene, B, 24 + 4 + 1 + 1, need)
        walk = dense_work(res, need)
        print(f"[{label}] any_hit{what}: {int(active.sum())} live sun rays "
              f"of {B}, occluded {got[active].float().mean().item():.4f} "
              f"(the slice's {slice_occ:.4f}); {frac:.2e} of the slice "
              f"differ; kernel {ms:.3f} ms ({call_ms:.3f} ms a call), "
              f"plain {plain_ms:.3f} ms, bound {work['bound_ms']:.4f} ms "
              f"({work['bound_by']}); {walk['text']}", flush=True)
        if entry is None:
            entry = {"scene": label, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, **walk["numbers"], **work}
    if label == "bundled":
        check_padding_untouched(label, scene, org, dirn, P_off, wi, hit,
                                4096)
    results["any_hit"].append({**entry, "max_abs_err": float(worst > 0)})


def check_gather(label, scene, inputs, ntheta, nphi, n_slice, results,
                 names=("ao_occlusion", "ao_occlusion_bits")):
    """Phase 3's AO gather on one tile's inputs (P_off, b0, b1, b2, hit,
    jitter) at ntheta x nphi strata: the counts and the per-stratum bits
    through the wrappers against one run of the twin, on a slice of
    n_slice lanes (on every hit lane when n_slice is None); then each
    kernel of `names` timed on the tile's compacted lanes, with its
    bound.  Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import ao

    P_off, b0, b1, b2, hit, jitter = inputs
    B, S = P_off.shape[0], ntheta * nphi
    n_tiles = scene.boxes.shape[1]
    occ = ao.ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi)
    occ_b, bits, u01 = ao.ao_occlusion_bits(scene, P_off, b0, b1, b2, hit,
                                            jitter, ntheta, nphi)
    if not torch.equal(occ, occ_b):
        raise AssertionError("ao_occlusion_bits: counts differ from the "
                             "plain gather's")
    if not torch.equal(ao.unpack_bits(bits, S).sum(dim=0).float(), occ):
        raise AssertionError("ao_occlusion_bits: bits disagree with counts")
    order, nhit = ao.compaction_order(scene.bbox_min, scene.bbox_max, P_off,
                                      b2, hit, n_tiles)
    lanes = torch.arange(B, device="cuda")
    if n_slice is not None:
        lo = max(0, B // 2 - n_slice // 2)
        lanes = lanes[lo : lo + n_slice]
    lanes = lanes[hit[lanes]]
    frame = torch.cat([P_off, b0, b1, b2], dim=1)
    ref_occ, ref_bits = ao.ao_occlusion_reference(
        scene.occ, frame[lanes].T.contiguous(), u01[:, lanes], ntheta, nphi,
        lane_chunk=65536, want_bits=True)
    torch.cuda.synchronize()
    diff = (occ[lanes] - ref_occ).abs()
    frac = (diff != 0).float().mean().item()
    if diff.max().item() > 1 or frac > 1e-4:
        raise AssertionError(f"ao_occlusion: {frac:.2e} of lanes differ, "
                             f"max {diff.max().item()}")
    if torch.any(occ[~hit] != 0) or torch.any(bits[:, ~hit] != 0):
        raise AssertionError("ao_occlusion: a missed lane has occlusion")
    bits_frac = (bits[:, lanes] != ref_bits).any(dim=0).float().mean().item()
    if bits_frac > 1e-4:
        raise AssertionError(f"ao_occlusion_bits: {bits_frac:.2e} of lanes "
                             "differ")
    rays = frame[order].T.contiguous()
    n = int(nhit)
    # no pad slot tested: a box around the scene in the pad slots, which
    # the twin meets on every stratum of a slice, changes no answer
    bad = occ_poisoned(scene)
    met = (ao.ao_occlusion_reference(
        bad.occ, rays[:, :256], jitter[:, :256], ntheta, nphi) == S
           ).float().mean().item()
    same = True
    for want_bits in (False, True):
        clean, poison = (ao.ao_occlusion_kernel(sc, rays, jitter, nhit,
                                                ntheta, nphi, want_bits)
                         for sc in (scene, bad))
        if not want_bits:
            clean, poison = (clean,), (poison,)
        same &= all(torch.equal(x, y) for x, y in zip(clean, poison))
    print(f"[{label}] gather padding: {scene.n_pad - scene.n_tris} pad "
          f"slots past triangle {scene.n_tris} hold a box around the scene "
          f"that the twin meets on {met:.4f} of 256 lanes' strata; counts "
          f"and bits {'unchanged' if same else 'CHANGED'}: no pad slot "
          f"tested", flush=True)
    if not same or met < 0.99:
        raise AssertionError(f"{label}: the gather tested a pad slot, or "
                             f"the poison is not met ({met})")
    # the work this data needs (gather_need: the box and triangle tests
    # up to each stratum's occluder, at the kernel's grain; the strata's
    # directions not counted); its occluders must be the kernel's bits
    hl = torch.nonzero(hit)[:, 0]
    need = gather_need(scene, P_off[hl], b0[hl], b1[hl], b2[hl], u01[:, hl],
                       ntheta, nphi)
    need_frac = (need["occluded"] != ao.unpack_bits(bits[:, hl], S)).any(
        dim=0).float().mean().item()
    if need_frac > 1e-4:
        raise AssertionError(f"gather_need: its occluders disagree with the "
                             f"kernel's bits on {need_frac:.2e} of lanes")
    ao_tests = need["tests"]
    ao_ops = float(ao_tests * AO_OPS
                   + (need["tiles"] + need["groups"]) * SLAB_OPS)
    ao_bytes = (B * (48 + 8 + 4) + scene.n_pad * 48
                + (n_tiles + scene.sub_boxes.shape[1]) * 32)
    for name in names:
        want_bits = name == "ao_occlusion_bits"
        err_ = float(bits_frac > 0) if want_bits else diff.max().item()
        out, stats = ao.ao_occlusion_kernel(scene, rays, jitter, nhit, ntheta,
                                            nphi, want_bits, counters=True)
        if want_bits:
            same = (torch.equal(out[0], occ_b[order])
                    and torch.equal(out[1], bits[:, order]))
        else:
            same = torch.equal(out, occ_b[order])
        if not same:
            raise AssertionError(f"{name}: the counting launch answers "
                                 "otherwise")
        walk = gather_work(stats, need)
        ms = cuda_ms(lambda: ao.ao_occlusion_kernel(
            scene, rays, jitter, nhit, ntheta, nphi, want_bits), 5)
        plain_ms = cuda_ms(lambda: ao.ao_occlusion_reference(
            scene.occ, rays[:, :n], jitter[:, :n], ntheta, nphi,
            lane_chunk=65536, want_bits=want_bits), 1)
        work = bound(ao_bytes + (B * 4 * bits.shape[0] if want_bits else 0),
                     ao_ops)
        print(f"[{label}] {name}: {n} hit lanes, {ntheta}x{nphi} strata, "
              f"mean occluded {occ[hit].mean().item():.3f}/{S}, {len(lanes)} "
              f"compared, counts differ on {frac:.2e}, bits on "
              f"{bits_frac:.2e}; needed {need['tiles']} tile and "
              f"{need['groups']} group box tests, {ao_tests} stratum-"
              f"triangle tests; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{work['bound_ms']:.3f} ms ({work['bound_by']}); "
              f"{walk['text']}", flush=True)
        results[name].append(
            {"scene": label, "strata": S, "max_abs_err": err_, "ms": ms,
             "plain_ms": plain_ms, "tests": ao_tests,
             "tile_box_tests": need["tiles"],
             "group_box_tests": need["groups"], **walk["numbers"], **work})


def check_sky_gather(results, log: str):
    """Phase 37: the sunsky gather's sky (csrc/ao.cu sky_gather_kernel) on
    the headline tile (the bundled scene as shipped, 640x480, 3x3, 64
    rays: 518,400 lanes, S = 64), on kernel 3b's own compacted bits of
    it, against its plain twin on every hit lane: each lane's sum within
    1e-5 of its value, relatively, plus 1e-3; lanes at or past nact 0;
    the counters' open pairs the clear bits of the hit lanes.  Prints the
    kernel's device ms (profiler) and ms a launch (events), the twin's,
    the bound (SKY_OPS a pair the counters count, or the bytes), the open
    share and the registers and spills (a spill in the render path's
    instantiation fails; the counting one's is printed); one frame of the
    headline renderer must launch the kernel once a tile (6).  Appends to
    results["sky_gather"]."""
    import torch
    from profile_gather import kernel_ms

    from lucille_tpu_torch.accel import ao
    from lucille_tpu_torch.render.renderer import Renderer

    ntheta = nphi = 8
    S = ntheta * nphi
    r = Renderer(bundled_state(640, 480, 3, 64).scene, tile_size=TILE,
                 device="cuda")
    sky = next(li.sunsky for li in r.lights if li.type == "sunsky")
    P_off, b0, b1, b2, hit, jitter = ao_gather_inputs(r)
    B = P_off.shape[0]
    _order, nhit, rays, (_occ, bits) = ao._gather(
        r.scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi, True)
    n = int(nhit)
    col, cnt = ao.sky_gather_kernel(rays, jitter, bits, nhit, ntheta, nphi,
                                    sky, counters=True)
    if not torch.equal(ao.sky_gather_kernel(rays, jitter, bits, nhit, ntheta,
                                            nphi, sky), col):
        raise AssertionError("sky_gather: the counting launch answers "
                             "otherwise")
    ref = ao.sky_gather_reference(rays[:, :n], jitter[:, :n], bits[:, :n],
                                  ntheta, nphi, sky)
    rel = ((col[:n] - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    ok = bool(((col[:n] - ref).abs() <= 1e-5 * ref.abs() + 1e-3).all())
    if not ok or torch.any(col[n:] != 0):
        raise AssertionError(f"sky_gather: max relative error {rel:.2e}, or "
                             "a lane past nact is not 0")
    open_pairs = int(cnt["open_pairs"])
    if (open_pairs != int((~ao.unpack_bits(bits[:, :n], S)).sum())
            or int(cnt["live_lanes"]) != n):
        raise AssertionError(f"sky_gather: counters {cnt} against the bits")
    launch = lambda: ao.sky_gather_kernel(  # noqa: E731
        rays, jitter, bits, nhit, ntheta, nphi, sky)
    ms = kernel_ms(launch, "sky_gather")[0]
    launch_ms = cuda_ms(launch, 20)
    plain_ms = cuda_ms(lambda: ao.sky_gather_reference(
        rays[:, :n], jitter[:, :n], bits[:, :n], ntheta, nphi, sky), 2)
    # read: 9 basis floats, 2 uniforms and the bits words of a live lane;
    # written: 3 floats a lane
    work = bound(n * 4 * (9 + 2 + bits.shape[0]) + B * 12,
                 float(open_pairs * SKY_OPS))
    entries = {f"sky_gather_kernel<{'ILb1E' in name}>": v
               for name, v in ptxas_entries(log).items()
               if "sky_gather_kernel" in name}
    if len(entries) != 2 or entries["sky_gather_kernel<False>"][1]:
        raise AssertionError(f"sky_gather_kernel: no report, or the render "
                             f"path's instantiation spills: {entries}")
    ao.SKY_COUNTS.reset()
    r.render_frame()
    torch.cuda.synchronize()
    frame_launches = ao.SKY_COUNTS.kernel
    if frame_launches != 6:
        raise AssertionError(f"sky_gather: {frame_launches} launches in a "
                             "headline-sunsky frame, not 6")
    print(f"[headline-sunsky] sky_gather: {n} of {B} lanes live, {S} strata, "
          f"{open_pairs} open pairs (open share {open_pairs / (n * S):.4f}), "
          f"max relative error {rel:.2e}; kernel {ms:.4f} ms ({launch_ms:.4f}"
          f" ms a launch), plain {plain_ms:.3f} ms, bound "
          f"{work['bound_ms']:.4f} ms ({work['bound_by']}); (registers, "
          f"spill bytes) {entries}; {frame_launches} launches a frame",
          flush=True)
    results["sky_gather"].append(
        {"scene": "headline-sunsky", "strata": S, "max_abs_err": rel,
         "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
         "open_pairs": open_pairs, "live_lanes": n,
         "registers": {k: v[0] for k, v in entries.items()},
         "frame_launches": frame_launches, **work})


def render_checked(label, r, out_name, path, max_mean=None):
    """Phases 4, 6 and 8 on Renderer r: two warm-up frames (a tile graph
    is captured the second time its tile is seen, render/graphs.py), then
    one counted frame through the display driver into an .hdr that is
    read back and checked, then best of 2.  `path` names the kernels the
    frame must launch; every other kernel must launch none, and no twin
    may run; no tile of the counted frame may wait on the card
    (`no_host_sync`).  The counted frame runs under the profiler: the
    launches its wrappers counted (a replayed tile adds its capture's)
    must be the hand-written kernels its device trace shows.
    The image mean must lie in (0, max_mean] (default 1, 1e6 under a
    sunsky light); an imager's frame is written again after the
    post-pass, as the CLI writes it.  Returns (the counted frame's
    launches of the path's kernels, best frame seconds, the counted frame
    as read back)."""
    import torch

    from lucille_tpu_torch.display.drivers import get_display_driver
    from lucille_tpu_torch.imageio.rgbe import read_hdr

    from torch.profiler import ProfilerActivity, profile

    r.render_frame()  # warm-up: each tile seen once
    r.render_frame()  # each tile captured, where its integrator allows
    torch.cuda.synchronize()
    counts = counters()
    for c in counts.values():
        c.reset()
    OUT.mkdir(parents=True, exist_ok=True)
    path_file = OUT / out_name
    drv = get_display_driver("file")
    opt = r.desc.options
    drv.open(str(path_file), opt.width, opt.height)
    with no_host_sync(r), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        frame = r.render_frame(tile_cb=drv.write)
        torch.cuda.synchronize()
    if opt.imager:
        drv.write(0, 0, frame)
    drv.close()
    launches = {k: c.kernel for k, c in counts.items()}
    traced = traced_launches(prof)
    if traced != by_kernel(launches):
        raise AssertionError(f"{label}: the device trace shows {traced} "
                             f"launches, the wrappers counted "
                             f"{by_kernel(launches)}")
    if min(launches[k] for k in path) <= 0:
        raise AssertionError(f"{label}: a kernel was not launched: {launches}")
    if any(launches[k] for k in counts if k not in path):
        raise AssertionError(f"{label}: a kernel off the path ran: {launches}")
    if any(c.plain for c in counts.values()):
        raise AssertionError(f"{label}: a plain twin ran on the card")
    img = read_hdr(path_file)[::-1]  # the file driver flips rows
    if img.shape != (opt.height, opt.width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: bad image {img.shape}")
    mean = float(img.mean())
    sunsky = any(li.type == "sunsky" for li in r.lights)
    if max_mean is None:
        max_mean = 1e6 if sunsky else 1.0
    if not 0.0 < mean <= max_mean:
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
          f"method {opt.render_method or 'ao'}, {opt.gather_nsamples} AO "
          f"rays, tile {r.tile_size}, accel {r.scene.accel}"
          f"{', sunsky' if sunsky else ''}: image mean {mean:.4f}, launches "
          f"{launches}; frame {best:.4f} s (samples "
          f"{[round(t, 4) for t in times]}), {nrays} rays, "
          f"{nrays / best / 1e6:.1f} Mrays/s", flush=True)
    return launches, best, img


def build_renderer(label, make_state, tile):
    """A Renderer on the card, with the host's seconds for the scene
    description, the compile, and the tile-BVH build inside it."""
    from lucille_tpu_torch.base.timer import get_timer
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
    """Phase 7 for one scene: both tile-BVH kernels on the scene's first
    tile against their plain twins.  Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.accel.bvh_ao import conetile_rays
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.kernels import build
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
    tris, nodes, depth = scene.tris, scene.nodes, scene.tree_depth
    inf = lambda n: torch.full((n,), float("inf"), device="cuda")  # noqa: E731
    leaf_real = scene.leaf_real

    # -- tile-BVH closest hit on the eye rays
    launch = lambda o, d: bvh_isect.bvh_closest_hit(  # noqa: E731
        tris, nodes, o, d, depth=depth, leaf_real=leaf_real)
    got = launch(org, dirn)
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
    ms, call_ms = hit_kernel_ms(lambda: launch(org, dirn), "bvh_closest_hit")
    ms_slice = hit_kernel_ms(lambda: launch(org[sl], dirn[sl]),
                             "bvh_closest_hit")[0]
    hit_rate = (got["tri"] >= 0).float().mean().item()
    # the work the data needs: every eye ray walked near child first,
    # real triangles only; the kernel walks exactly that walk
    need = need_walk(tris, nodes, org, dirn, True, depth)
    check_closest_walk(f"{label} bvh_closest_hit", got, need)
    work = bound(B * (28 + 16) + reached_bytes(need),
                 need["tests"] * MT_OPS + need["inner"] * NODE_OPS)
    walk = walk_report(got, need, 1)
    regs, spill = kernel_registers(build.library().log, "bvh_closest_kernel")
    print(f"[{label}] bvh_closest_hit (a warp a ray; {regs} registers, "
          f"{spill} bytes spilled): {B} eye rays, hit rate {hit_rate:.4f}; "
          f"{walk['text']}; tri, node visits and triangle tests equal "
          f"need_walk's on every ray; on {n_closest} rays tri "
          f"differs on {differ:.2e}, max |t,u,v err| {err:.3e}; kernel "
          f"{ms:.3f} ms on the device ({ms_slice:.3f} ms on the slice; a "
          f"call {call_ms:.3f} ms with the wrapper's host work), plain "
          f"{plain_ms:.3f} ms on the slice, bound {work['bound_ms']:.4f} ms "
          f"({work['bound_by']}, {need['distinct_nodes']} nodes and "
          f"{need['leaf_tris']} leaf triangles reached; kernel / bound "
          f"{ms / work['bound_ms']:.1f}x)", flush=True)
    results["bvh_closest_hit"].append(
        {"scene": label, "rays": B, "ms": ms, "call_ms": call_ms,
         "slice": n_closest, "ms_slice": ms_slice, "plain_ms": plain_ms,
         "max_abs_err": err, "tri_differs": differ, "registers": regs,
         "spill": spill,
         **walk["numbers"],
         **{f"need_{k}": need[k] for k in ("distinct_nodes", "leaf_tris")},
         **work})

    # -- tile-BVH any-hit on the tile's gather rays, 8x8 strata
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    jitter = r.sampler(x0, y0).uniform((), (2, B))
    oo, dd, _order, _layout = conetile_rays(scene, P_off, b0, b1, b2, hit,
                                            jitter, 8, 8)
    R = oo.shape[0]
    got = bvh_isect.bvh_any_hit(tris, nodes, oo, dd, depth=depth,
                                leaf_real=leaf_real)
    live = int(hit.sum()) * 64  # the live gather rays lead the layout
    lo = max(0, live // 2 - n_any // 2)
    sl = slice(lo, lo + n_any)
    ref, plain_ms = timed(lambda: bvh_isect.bvh_any_hit_reference(
        tris, oo[sl], dd[sl], inf(n_any)))
    frac = (got["occ"][sl] != ref["occ"]).float().mean().item()
    if frac > 1e-4:
        raise AssertionError(f"{label} bvh_any_hit: {frac:.2e} of rays differ")
    ms = cuda_ms(lambda: bvh_isect.bvh_any_hit(
        tris, nodes, oo, dd, depth=depth, leaf_real=leaf_real), 3)
    ms_slice = cuda_ms(lambda: bvh_isect.bvh_any_hit(
        tris, nodes, oo[sl], dd[sl], depth=depth, leaf_real=leaf_real), 5)
    # the work the data needs, counted on a random sample of the rays and
    # scaled to all R
    gen = torch.Generator(device="cuda").manual_seed(11)
    sample = torch.randperm(R, device="cuda", generator=gen)[:N_NEED]
    need = need_walk(tris, nodes, oo[sample], dd[sample], False, depth)
    need_differ = (need["hit"] != got["occ"][sample]).float().mean().item()
    if need_differ > 1e-4:
        raise AssertionError(f"{label} need_walk: occlusion differs from "
                             f"the any-hit's on {need_differ:.2e}")
    scale = R / len(sample)
    # bytes: the nodes and leaves the sample reaches (fewer than all R rays
    # reach, so still a floor)
    work = bound(R * (28 + 1) + reached_bytes(need),
                 scale * (need["tests"] * SV_OPS + need["inner"] * NODE_OPS))
    walk = walk_report(got, need, scale)
    regs, spill = kernel_registers(build.library().log, "bvh_any_kernel")
    print(f"[{label}] bvh_any_hit: {R} gather rays ({live} live), occluded "
          f"{got['occ'][:live].float().mean().item():.4f}; {walk['text']}; "
          f"on {n_any} rays {frac:.2e} differ; {regs} registers, {spill} "
          f"bytes spilled; kernel {ms:.3f} ms "
          f"({ms_slice:.3f} ms on the slice), plain {plain_ms:.3f} ms on "
          f"the slice, bound {work['bound_ms']:.3f} ms ({work['bound_by']}, "
          f"kernel / bound {ms / work['bound_ms']:.1f}x)", flush=True)
    bounded = check_bounded_any_hit(label, scene, P_off, hit, n_any // 8)
    results["bvh_any_hit"].append(
        {"scene": label, "rays": R, "ms": ms, "slice": n_any,
         "ms_slice": ms_slice, "plain_ms": plain_ms,
         "max_abs_err": float(max(frac, bounded) > 0), "differs": frac,
         "bounded_differs": bounded, "registers": regs, "spill": spill,
         "need_sample": len(sample), **walk["numbers"], **work})


def walk_report(got, need, scale) -> dict:
    """A warp walk's work against need_walk's: node visits of the rays
    that reach the node and real triangles they tested, against the
    per-ray near-first walk's counts (scaled from its sample), and the
    SIMT efficiency in the leaves, ray tests over 32 x the warps'
    triangle steps (kernels 5 and 6: a walk a warp of 32 rays, a step one
    ray against up to 32 triangles; kernel 4: a walk a warp for one ray,
    a step the ray against up to 32 triangles).  Returns {"text",
    "numbers"}."""
    k = {key: int(got[key]) for key in ("ntrav", "ntests", "warp_ntrav",
                                        "warp_ntests")}
    need_nodes, need_tests = scale * need["nodes"], scale * need["tests"]
    simt = k["ntests"] / max(32 * k["warp_ntests"], 1)
    text = (f"{k['ntrav']} lane node visits and {k['ntests']} lane triangle "
            f"tests done ({k['ntrav'] / need_nodes:.2f}x / "
            f"{k['ntests'] / need_tests:.2f}x the {need_nodes:.0f} and "
            f"{need_tests:.0f} needed), {k['warp_ntrav']} warp node visits "
            f"and {k['warp_ntests']} warp triangle steps (SIMT efficiency "
            f"{simt:.3f})")
    return {"text": text, "numbers": {
        **{f"kernel_{key}": v for key, v in k.items()},
        "simt_efficiency": simt,
        **{f"need_{key}": scale * need[key]
           for key in ("inner", "nodes", "tests")}}}


def check_closest_walk(name, got, need) -> None:
    """Kernel 4 walks need_walk's walk exactly: on every ray it reports
    need_walk's triangle (its first leaf keeps an exact tie in t) and t
    (within 1e-6 relative, the twins' tolerance), and its node visits
    and real triangle tests equal need_walk's."""
    import torch

    wrong = int((got["tri"].long() != need["tri"]).sum())
    done = (int(got["ntrav"]), int(got["ntests"]))
    if wrong or done != (need["nodes"], need["tests"]):
        raise AssertionError(
            f"{name}: tri differs from need_walk's on {wrong} rays; node "
            f"visits and tests {done}, need_walk {need['nodes']}, "
            f"{need['tests']}")
    torch.testing.assert_close(got["t"], need["t"], rtol=1e-6, atol=1e-7)


def reached_bytes(need) -> int:
    """The bytes a walk must read at least once: the real triangles of
    the leaves the rays reach (36 B each, the nine rows) and the nodes
    they enter (32 B each)."""
    return need["leaf_tris"] * 36 + need["distinct_nodes"] * 32


def check_bounded_any_hit(label, scene, P_off, hit, n_slice) -> float:
    """Kernel 5 with a finite per-ray tmax (the shadow rays' case) on the
    tile's shading points toward a fixed direction, against its twin on
    a slice of the hit lanes.  Returns the slice's fraction that differs
    (<= 1e-4)."""
    import torch

    from lucille_tpu_torch.accel import bvh_isect

    B = P_off.shape[0]
    # a low sun (19 degrees above the terrain's plane): a fair share of
    # the shading points lie in shadow
    wi = torch.nn.functional.normalize(
        torch.tensor([1.0, 0.35, 0.2], device="cuda"), dim=0)
    wi = wi.expand(B, 3).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(17)
    diag = float(torch.linalg.norm(scene.bbox_max - scene.bbox_min))
    tmax = 0.25 * diag * torch.rand(B, device="cuda", generator=gen)
    got = bvh_isect.bvh_any_hit(scene.tris, scene.nodes, P_off, wi, tmax,
                                depth=scene.tree_depth,
                                leaf_real=scene.leaf_real)
    lanes = torch.nonzero(hit)[:, 0]
    lanes = lanes[max(0, len(lanes) // 2 - n_slice // 2):][:n_slice]
    ref = bvh_isect.bvh_any_hit_reference(scene.tris, P_off[lanes],
                                          wi[lanes], tmax[lanes])["occ"]
    frac = (got["occ"][lanes] != ref).float().mean().item()
    occ = ref.float().mean().item()
    print(f"[{label}] bvh_any_hit, finite tmax: {len(lanes)} hit lanes' "
          f"shadow rays compared, {occ:.4f} occluded, {frac:.2e} differ",
          flush=True)
    if frac > 1e-4 or not 0.01 < occ < 0.99:
        raise AssertionError(f"{label} bvh_any_hit with tmax: {frac:.2e} "
                             f"differ, {occ:.4f} occluded")
    return frac


def ptxas_entries(log: str) -> dict:
    """{mangled entry name: (registers, spill bytes stored + loaded)} of
    every kernel entry in ptxas's report, from the build log."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry" in line:
            name, spill = line.split("'")[1], 0
        elif name and "spill stores" in line:
            f = line.split()
            spill = int(f[f.index("spill") - 2]) + int(f[-4])
        elif name and "Used " in line and "registers" in line:
            out[name] = (int(line.split("Used ")[1].split()[0]), spill)
            name = None
    return out


def kernel_registers(log: str, kernel: str) -> tuple[int, int]:
    """(registers, spill bytes) of the entry whose mangled name holds
    `kernel`; raises if it spills."""
    for name, (regs, spill) in ptxas_entries(log).items():
        if kernel in name:
            if spill:
                raise AssertionError(f"{kernel}: {spill} bytes spilled")
            return regs, spill
    raise AssertionError(f"no ptxas report for {kernel}")


def gather_registers(log: str) -> dict:
    """{"ao_kernel<C, bits, counters>": (registers, spill bytes)} of every
    instantiation of csrc/ao.cu's kernel; raises if one spills or none is
    reported."""
    import re

    out = {}
    for name, (regs, spill) in ptxas_entries(log).items():
        m = re.search(r"9ao_kernelILi(\d+)ELb([01])ELb([01])E", name)
        if m:
            c, bits, count = m.groups()
            key = f"ao_kernel<{c}, {bool(int(bits))}, {bool(int(count))}>"
            out[key] = (regs, spill)
    if not out or any(spill for _regs, spill in out.values()):
        raise AssertionError(f"ao_kernel: no report or a spill: {out}")
    return out


def first_tile_rays(r):
    """The eye rays of the scene's first tile on the card, and (x0, y0)."""
    import torch

    from lucille_tpu_torch.render.renderer import tile_eye_rays
    from lucille_tpu_torch.render.tiles import tile_list
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples

    opt, tile = r.desc.options, r.tile_size
    xs, ys = (int(v) for v in opt.current_display().sampling_rates)
    sub = torch.tensor(subpixel_samples(xs, ys)[0], dtype=torch.float32,
                       device="cuda")
    x0, y0, _i, _j = tile_list(opt.width, opt.height, tile,
                               opt.bucket_order)[0]
    org, dirn = tile_eye_rays(r.camera, x0, y0, tile, tile, sub)
    return org, dirn, x0, y0


def check_closest_active(label, r, n_slice, results):
    """Phase 10: the scene's closest-hit kernel on its first tile with a
    bounce wavefront's active mask (half the rays live) against its
    twin; dead rays report a miss.  Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import bvh_isect, isect

    scene = r.scene
    org, dirn, _x0, _y0 = first_tile_rays(r)
    B = org.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    active = torch.rand(B, device="cuda", generator=gen) < 0.5
    tris = scene.tris
    dense = scene.accel == "dense"
    name = "closest_hit" if dense else "bvh_closest_hit"
    if dense:
        launch = lambda a: isect.closest_hit(  # noqa: E731
            scene, org, dirn, active=a)
    else:
        launch = lambda a: bvh_isect.bvh_closest_hit(  # noqa: E731
            tris, scene.nodes, org, dirn, None, a, depth=scene.tree_depth,
            leaf_real=scene.leaf_real)
    got = launch(active)
    hits = torch.nonzero(got["tri"] >= 0)[:, 0]
    mid = int(hits[len(hits) // 2]) if len(hits) else B // 2
    lo = min(max(0, mid - n_slice // 2), max(0, B - n_slice))
    sl = slice(lo, lo + n_slice)
    if dense:
        ref = isect.closest_hit_reference(tris, org[sl], dirn[sl],
                                          active=active[sl])
    else:
        ref = bvh_isect.bvh_closest_hit_reference(
            tris, org[sl], dirn[sl],
            torch.full((n_slice,), float("inf"), device="cuda"), active[sl])
    torch.cuda.synchronize()
    if torch.any(got["tri"][~active] >= 0) or not torch.all(
            torch.isinf(got["t"][~active])):
        raise AssertionError(f"{label} {name}: a dead ray reports a hit")
    err, differ = compare_closest(got, ref, sl, f"{label} {name} with active",
                                  1e-4 if dense else 1e-3)
    hit_differ = ((got["tri"][sl] >= 0) != (ref["tri"] >= 0)).float().mean()
    if hit_differ.item() > 1e-4:
        raise AssertionError(f"{label} {name} with active: hit differs on "
                             f"{hit_differ.item():.2e}")
    walked = ""
    if not dense:  # the live rays walk need_walk's walk exactly
        live = torch.nonzero(active)[:, 0]
        need = need_walk(tris, scene.nodes, org[live], dirn[live], True,
                         scene.tree_depth)
        check_closest_walk(f"{label} {name} with active",
                           {**got, "tri": got["tri"][live],
                            "t": got["t"][live]}, need)
        walked = (f", tri, {need['nodes']} node visits and {need['tests']} "
                  f"triangle tests equal need_walk's on the live rays")
    all_live = torch.ones_like(active)
    ms = cuda_ms(lambda: launch(active), 5)
    ms_all = cuda_ms(lambda: launch(all_live), 5)
    print(f"[{label}] {name} with active: {int(active.sum())} live of {B}, "
          f"live hit rate {(got['tri'][active] >= 0).float().mean().item():.4f}"
          f"; on {n_slice} rays tri differs on {differ:.2e}, max |t,u,v err| "
          f"{err:.3e}{walked}; kernel {ms:.3f} ms (every ray live "
          f"{ms_all:.3f} ms)", flush=True)
    results[name].append({"scene": f"{label}-active", "max_abs_err": err,
                          "ms": ms, "ms_all_live": ms_all,
                          "tri_differs": differ})


def ao_gather_inputs(r):
    """The AO frame's gather on the scene's first tile: (P_off, b0, b1,
    b2, hit, the tile stream's (2, B) draw)."""
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.transport.ao import shading_frame

    org, dirn, x0, y0 = first_tile_rays(r)
    res = closest_hit(r.scene, org, dirn)
    P_off, b0, b1, b2 = shading_frame(r.scene, org, dirn, res)
    return (P_off, b0, b1, b2, res["hit"],
            r.sampler(x0, y0).uniform((), (2, org.shape[0])))


def whitted_gather_inputs(r):
    """The dome's hemisphere gather of a Whitted frame's first bounce on
    the scene's first tile, as lights/sampling._hemisphere_occlusion
    builds it: the eye hits' face-forwarded shading normals and their
    basis, P + N eps, the hit mask, and the tile stream's (2, B) draw at
    fold(0) (the bounce), fold(1000) (the first light)."""
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.ops.frame import ortho_basis
    from lucille_tpu_torch.transport.common import face_forward, interp_hit

    org, dirn, x0, y0 = first_tile_rays(r)
    res = closest_hit(r.scene, org, dirn)
    h = interp_hit(r.scene, res, org, dirn)
    N = face_forward(h["Ns"], dirn)
    b0, b1, b2 = ortho_basis(N)
    key = StreamKey(r.sampler(x0, y0)).fold(0).fold(1000)
    return (h["P"] + N * r.scene.eps, b0, b1, b2, res["hit"],
            key.uniform((2, org.shape[0])))


def check_fused_gather(label, r, n_slots, results, inputs, ntheta=8, nphi=8):
    """Phase 10: the fused gather (kernel 6) on the scene's first tile,
    inputs (P_off, b0, b1, b2, hit, jitter) at ntheta x nphi strata,
    against its plain twin on n_slots compacted slots, every slot
    compared; its bound from the work need_walk counts on a random
    sample of the live slots.  Appends to results["bvh_ao_fused"]."""
    import torch

    from lucille_tpu_torch.accel import bvh_ao
    from lucille_tpu_torch.accel.ao import compaction_order, stratum_directions
    from lucille_tpu_torch.kernels import build

    scene = r.scene
    P_off, b0, b1, b2, hit, jitter = inputs
    B, S = P_off.shape[0], ntheta * nphi
    order, nhit = compaction_order(scene.bbox_min, scene.bbox_max, P_off, b2,
                                   hit, bvh_ao.MORTON_TILES)
    rays = torch.cat([P_off, b0, b1, b2], dim=1)[order].T.contiguous()
    tris, nodes, leaf_real = scene.tris, scene.nodes, scene.leaf_real
    depth = scene.tree_depth
    launch = lambda: bvh_ao.bvh_ao_fused_kernel(  # noqa: E731
        tris, nodes, leaf_real, rays, jitter, nhit, ntheta, nphi,
        depth=depth)
    occ, stats = launch()
    n = int(nhit)
    lo = max(0, n // 2 - n_slots // 2)
    sl = slice(lo, lo + n_slots)
    (ref, _st), plain_ms = timed(lambda: bvh_ao.bvh_ao_fused_reference(
        tris, rays[:, sl], jitter[:, sl], ntheta, nphi))
    diff = (occ[sl] - ref).abs()
    frac = (diff != 0).float().mean().item()
    if diff.max().item() > 1 or frac > 1e-4:
        raise AssertionError(f"{label} bvh_ao_fused: {frac:.2e} of slots "
                             f"differ, max {diff.max().item()}")
    if torch.any(occ[n:] != 0):
        raise AssertionError(f"{label} bvh_ao_fused: a slot past nact counts")
    if not 0.01 * S < ref.mean().item() < 0.99 * S:
        raise AssertionError(f"{label} bvh_ao_fused: the slice's mean "
                             f"occlusion {ref.mean().item():.3f} of {S}")
    ms = cuda_ms(launch, 3)
    rays_s, jit_s = rays[:, sl].contiguous(), jitter[:, sl].contiguous()
    n_s = torch.full((), n_slots, dtype=torch.int32, device="cuda")
    ms_slice = cuda_ms(lambda: bvh_ao.bvh_ao_fused_kernel(
        tris, nodes, leaf_real, rays_s, jit_s, n_s, ntheta, nphi,
        depth=depth), 5)

    # the work the data needs: a random sample of the live slots, every
    # stratum of each walked near child first over real triangles, its
    # counts equal to the kernel's; scaled to the n live slots
    gen = torch.Generator(device="cuda").manual_seed(13)
    slots = torch.randperm(n, device="cuda", generator=gen)[:N_NEED // S]
    dirs = stratum_directions(*(rays[3 * c : 3 * c + 3, slots].T
                                for c in (1, 2, 3)),
                              jitter[:, slots], ntheta, nphi)  # (S, m, 3)
    o = rays[0:3, slots].T[None].expand(S, len(slots), 3).reshape(-1, 3)
    need = need_walk(tris, nodes, o, dirs.reshape(-1, 3).contiguous(), False,
                     scene.tree_depth)
    counts = need["hit"].reshape(S, len(slots)).sum(dim=0).float()
    need_differ = (counts != occ[slots]).float().mean().item()
    if need_differ > 1e-4:
        raise AssertionError(f"{label} need_walk: counts differ from the "
                             f"fused gather's on {need_differ:.2e} of slots")
    scale = n / len(slots)
    # bytes: the nodes and leaves the sample reaches (a floor)
    work = bound(B * (48 + 8 + 4) + reached_bytes(need) + S * 4,
                 scale * (need["tests"] * SV_OPS + need["inner"] * NODE_OPS)
                 + n * S * DIR_OPS)
    walk = walk_report(stats, need, scale)
    regs, spill = kernel_registers(build.library().log, "bvh_ao_kernel")
    print(f"[{label}] bvh_ao_fused: {n} live slots of {B}, {ntheta}x{nphi} "
          f"strata, mean occluded {occ[:n].mean().item():.3f}/{S}; "
          f"{walk['text']} (need from {len(slots)} slots); on {n_slots} "
          f"slots {frac:.2e} differ; {regs} registers, {spill} bytes "
          f"spilled; kernel {ms:.3f} ms ({ms_slice:.3f} ms on the slice), "
          f"plain {plain_ms:.3f} ms on the slice, bound "
          f"{work['bound_ms']:.3f} ms ({work['bound_by']}, kernel / bound "
          f"{ms / work['bound_ms']:.1f}x)", flush=True)
    results["bvh_ao_fused"].append(
        {"scene": label, "strata": S, "lanes": B, "live": n, "ms": ms,
         "slice": n_slots, "ms_slice": ms_slice, "plain_ms": plain_ms,
         "registers": regs, "spill": spill,
         "max_abs_err": diff.max().item(), "differs": frac,
         "need_sample": len(slots), **walk["numbers"], **work})


def check_whitted_twins():
    """Phase 12: an 80x60 Whitted frame of the bundled scene on the card
    against the same frame on the CPU (`check_frame_twins`)."""
    check_frame_twins("whitted-twins", lambda: bundled_state(
        80, 60, sunsky=False, method="whitted"))


def check_fused_against_cone(label, cone, fused, lit_from):
    """Phase 13: means over the pixels `lit_from` renders as hits (AO
    above 0), within 0.01."""
    lit = lit_from[..., 0] > 0
    gap = abs(float(cone[lit].mean()) - float(fused[lit].mean()))
    print(f"[fused-vs-cone] {label}: means over {lit.mean():.4f} of the "
          f"pixels {cone[lit].mean():.5f} (cone) and {fused[lit].mean():.5f} "
          f"(fused), gap {gap:.5f} (< 0.01)", flush=True)
    if not (lit.mean() > 0.2 and gap < 0.01):
        raise AssertionError(f"{label}: the fused and cone frames disagree")


def check_goldens():
    """Phase 5: the port's 80x60 frames against CPU-lucille's."""
    from lucille_tpu_torch.imageio.rgbe import read_hdr
    from lucille_tpu_torch.render.renderer import Renderer

    golden = read_hdr(ROOT / "tests" / "golden" / "ao_80x60_ref.hdr")
    img = Renderer(bundled_state(80, 60, sunsky=False).scene, tile_size=32,
                   device="cuda").render_frame()
    diff = np.abs(golden - img[::-1]).mean(axis=-1)
    print(f"[golden] AO 80x60 against CPU-lucille: mean |diff| "
          f"{diff.mean():.5f} (< 0.01), pixels > 0.1: "
          f"{(diff > 0.1).mean():.5f} (< 0.005)", flush=True)
    if not (diff.mean() < 0.01 and (diff > 0.1).mean() < 0.005):
        raise AssertionError("the port's AO frame disagrees with CPU-lucille's")

    # the reference shades its sun with turbidity 0 (an unset field,
    # lucille_tpu/lights/sunsky.py:278-288)
    desc = bundled_state(80, 60).scene
    sky = next(li.sunsky for li in desc.lights if li.type == "sunsky")
    for li in desc.lights:
        if li.type == "sun":
            li.color = sky.sunlight_rgb(turbidity=0.0)
    golden = read_hdr(ROOT / "tests" / "golden" / "sunsky_80x60_ref.hdr")
    img = Renderer(desc, tile_size=32, device="cuda").render_frame()[::-1]
    gl, ml = golden.mean(-1), img.mean(-1)
    hit = ml > 0
    corr = np.corrcoef(gl.ravel(), ml.ravel())[0, 1]
    ratio = img[hit].mean(0) / golden[hit].mean(0)
    rel = (np.abs(ml - gl) / np.maximum(gl, 1.0))[hit].mean()
    print(f"[golden] sunsky 80x60 against CPU-lucille: correlation "
          f"{corr:.5f} (> 0.995), channel ratios "
          f"{[round(float(x), 4) for x in ratio]} (0.90-1.05), mean "
          f"relative error {rel:.4f} (< 0.08)", flush=True)
    if not (corr > 0.995 and (ratio > 0.90).all() and (ratio < 1.05).all()
            and rel < 0.08):
        raise AssertionError("the port's sunsky frame disagrees with "
                             "CPU-lucille's")


def cross_check_accels():
    """Phase 9: the n = 91 heightfield on the dense tiles and on the tile
    BVH; means over the pixels both render as hits, within 0.01."""
    from lucille_tpu_torch.render.renderer import Renderer

    imgs = {}
    for accel in ("pallas", "bvh"):
        r = Renderer(heightfield_state(91, accel=accel).scene,
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


def check_split_kernels(label, r, results, n_slice=2048):
    """Kernels 1 and 2 where the rays alone cannot fill the card: the
    first tile of the dense strata scan's frame (6,400 eye rays on the
    n = 258 terrain's 1,033 tiles), on which both split the triangle range
    across the grid (isect.split_layout).  The closest hit on the eye
    rays, the any-hit on the hit lanes' shadow rays toward a low sun, each
    against its twin on a slice (phase 3's tolerances), with its time,
    its twin's on every ray, its bound and its work against the need.
    Appends to results[name]."""
    import torch

    from lucille_tpu_torch.accel import isect
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.accel.pack import TC
    from lucille_tpu_torch.transport.ao import shading_frame

    scene = r.scene
    org, dirn, _x0, _y0 = first_tile_rays(r)
    B = org.shape[0]
    n_tiles = scene.n_pad // TC
    chunks, per = isect.split_layout(
        B, scene.n_tris, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    if chunks < 2:
        raise AssertionError(f"{label}: {B} rays do not split the range")
    lo = max(0, B // 2 - n_slice // 2)
    sl = slice(lo, lo + n_slice)
    inf = torch.full((B,), float("inf"), device="cuda")
    layout = (f"{B} rays on {n_tiles} tiles, {chunks} chunks of {per} "
              "supertiles")

    got = isect.closest_hit_kernel(scene, org, dirn)
    ref = isect.closest_hit_reference(scene.tris, org[sl], dirn[sl])
    err, differ = compare_closest(got, ref, sl, f"{label} closest_hit")
    ms, call_ms = hit_kernel_ms(
        lambda: isect.closest_hit_kernel(scene, org, dirn), "closest_hit")
    plain_ms = cuda_ms(lambda: isect.closest_hit_reference(scene.tris, org,
                                                           dirn), 1)
    t_end = torch.where(got["tri"] >= 0, torch.nextafter(got["t"], inf), inf)
    need = dense_need(scene, org, dirn, t_end)
    work = dense_bound(scene, B, 24 + 16, need)
    walk = dense_work(got, need)
    print(f"[{label}] closest_hit, split: {layout}; tri differs on "
          f"{differ:.2e} of {n_slice}, max |t,u,v err| {err:.3e}; kernel "
          f"{ms:.3f} ms ({call_ms:.3f} ms a call), plain {plain_ms:.3f} ms, "
          f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}); "
          f"{walk['text']}", flush=True)
    results["closest_hit"].append(
        {"scene": label, "chunks": chunks, "max_abs_err": err, "ms": ms,
         "call_ms": call_ms, "plain_ms": plain_ms, **walk["numbers"],
         **work})

    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    P_off = shading_frame(scene, org, dirn, res)[0]
    wi = torch.nn.functional.normalize(
        torch.tensor([1.0, 0.35, 0.2], device="cuda"), dim=0)
    wi = wi.expand(B, 3).contiguous()
    got = isect.any_hit_kernel(scene, P_off, wi, inf, hit, counters=True)
    ref = isect.any_hit_reference(scene.tris, P_off[sl], wi[sl], inf[sl],
                                  hit[sl])["occ"]
    frac = (got["occ"][sl] != ref).float().mean().item()
    occ = ref[hit[sl]].float().mean().item()
    if frac > 1e-4 or not 0.01 < occ < 0.99 or torch.any(
            got["occ"][~hit]):
        raise AssertionError(f"{label} any_hit, split: {frac:.2e} differ, "
                             f"{occ:.4f} of the live slice occluded, or a "
                             "dead ray occluded")
    ms, call_ms = hit_kernel_ms(
        lambda: isect.any_hit_kernel(scene, P_off, wi, inf, hit), "any_hit")
    plain_ms = cuda_ms(lambda: isect.any_hit_reference(scene.tris, P_off, wi,
                                                       inf, hit), 1)
    need = dense_need(scene, P_off, wi, inf, hit, got["occ"])
    work = dense_bound(scene, B, 24 + 4 + 1 + 1, need)
    walk = dense_work(got, need)
    print(f"[{label}] any_hit, split: {layout}; {int(hit.sum())} live sun "
          f"rays, the slice's {occ:.4f} occluded, {frac:.2e} differ; kernel "
          f"{ms:.3f} ms ({call_ms:.3f} ms a call), plain {plain_ms:.3f} ms, "
          f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}); "
          f"{walk['text']}", flush=True)
    results["any_hit"].append(
        {"scene": label, "chunks": chunks, "max_abs_err": float(frac > 0),
         "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
         **walk["numbers"], **work})


def isect_registers(log: str) -> dict:
    """{"closest_hit_kernel<split>": (registers, spill bytes), ...} of
    every entry of csrc/isect.cu; raises if one spills or is missing."""
    import re

    out = {}
    for name, (regs, spill) in ptxas_entries(log).items():
        m = re.search(r"(closest_hit_kernel|any_hit_kernel)ILb([01])E", name)
        if m:
            out[f"{m.group(1)}<{bool(int(m.group(2)))}>"] = (regs, spill)
        elif "closest_epilogue" in name:
            out["closest_epilogue"] = (regs, spill)
    if len(out) != 5 or any(spill for _regs, spill in out.values()):
        raise AssertionError(f"isect.cu: a report missing or a spill: {out}")
    return out


def check_dense_scan(results):
    """Phase 14: above MAX_TRIS_FOR_MEGAKERNEL padded triangles the dense
    tiles scan the strata through the dense any-hit (kernel 2), as
    lucille_tpu does.  The n = 258 terrain (132,098 triangles) on the
    dense tiles at 80x60, 2x2 samples, 16 rays, tile 40, plain and under
    the bundled scene's sunsky line, with phase 4's checks (the closest
    hit and the any-hit launched, no other kernel, no twin, no tile
    waiting on the card), the any-hit launched once a stratum (and sun)
    of each tile; then each against the same frame on the tile BVH (the
    cone gather, another draw of the same estimator): means over the
    pixels both render as hits within 0.01 (AO) and 1% (sunsky).  First
    kernels 1 and 2 on the split path at the scan's shape
    (`check_split_kernels`)."""
    from lucille_tpu_torch.accel.ao import MAX_TRIS_FOR_MEGAKERNEL
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list
    from lucille_tpu_torch.accel.gather import gather_kind

    for sunsky in (False, True):
        label = "heightfield258-scan" + ("-sunsky" if sunsky else "")
        imgs = {}
        for accel in ("pallas", "bvh"):
            desc = heightfield_state(258, 80, 60, pixelsamples=2, gather=16,
                                     accel=accel, sunsky=sunsky).scene
            r = Renderer(desc, tile_size=40, device="cuda")
            if accel == "bvh":
                imgs[accel] = r.render_frame()
                continue
            if not (r.scene.accel == "dense" and gather_kind(r.scene)
                    == "scan" and r.scene.tri_v0.shape[0]
                    > MAX_TRIS_FOR_MEGAKERNEL):
                raise AssertionError(f"{label}: not the dense scan")
            if not sunsky:
                check_split_kernels("heightfield258-scan", r, results)
            launches, _, imgs[accel] = render_checked(
                label, r, f"chip_smoke_{label}.hdr", ("closest_hit",
                                                      "any_hit"))
            opt = desc.options
            n_tiles = len(tile_list(80, 60, 40, opt.bucket_order))
            suns = sum(li.type == "sun" for li in r.lights)
            if launches["any_hit"] != n_tiles * (16 + suns):
                raise AssertionError(f"{label}: {launches['any_hit']} any-hit "
                                     f"launches, not {n_tiles} x {16 + suns}")
        dense, bvh = imgs["pallas"], imgs["bvh"]
        lit = (dense[..., 0] > 0) & (bvh[..., 0] > 0)
        a, b = float(dense[lit].mean()), float(bvh[lit].mean())
        gap = abs(a - b) / (b if sunsky else 1.0)
        print(f"[{label}] the dense scan against the tile BVH's cone gather: "
              f"means over {lit.mean():.4f} of the pixels {a:.5f} and "
              f"{b:.5f}, gap {gap:.5f} (< 0.01{', relative' if sunsky else ''})",
              flush=True)
        if not (lit.mean() > 0.2 and gap < 0.01):
            raise AssertionError(f"{label}: the scan and the tile BVH disagree")


def check_tmax_kernel(label, scene, org, dirn, tmax, active, n_slice,
                      results):
    """Phase 15 for one shape: kernel 1 with the finite per-ray tmax
    against its twin on a slice of the live rays (phase 3's tolerances);
    a miss reports t +inf and tri -1, a dead ray misses, and a ray whose
    tmax is its own hit's t misses (a hit needs t < tmax).  Its time, its
    twin's on every ray, its bound and its work against dense_need's
    count up to min(hit, tmax), and its registers (isect_registers fails
    on a spill).  Appends to results["closest_hit"]."""
    import torch

    from lucille_tpu_torch.accel import isect

    B = org.shape[0]
    live = (torch.ones(B, dtype=torch.bool, device="cuda") if active is None
            else active)
    chunks, per = isect.split_layout(
        B, scene.n_tris,
        torch.cuda.get_device_properties(0).multi_processor_count)
    lanes = torch.nonzero(live)[:, 0]
    mid = len(lanes) // 2
    lanes = lanes[max(0, mid - n_slice // 2) : mid + n_slice // 2]
    got = isect.closest_hit_kernel(scene, org, dirn, tmax, active)
    ref = isect.closest_hit_reference(scene.tris, org[lanes], dirn[lanes],
                                      tmax[lanes])
    err, differ = compare_closest(got, ref, lanes, f"{label} closest_hit")
    miss = got["tri"] < 0
    if not (torch.all(torch.isinf(got["t"][miss]))
            and torch.all(got["tri"][~live] < 0)):
        raise AssertionError(f"{label}: a miss with a finite t, or a dead "
                             "ray that hit")
    at_hit = torch.where(miss, tmax, got["t"])
    if torch.any(isect.closest_hit_kernel(scene, org, dirn, at_hit,
                                          active)["tri"] >= 0):
        raise AssertionError(f"{label}: a hit at t == tmax")
    hit_rate = (~miss[live]).float().mean().item()
    if not 0.01 < hit_rate < 0.99:
        raise AssertionError(f"{label}: {hit_rate:.4f} of the live rays hit")
    ms, call_ms = hit_kernel_ms(lambda: isect.closest_hit_kernel(
        scene, org, dirn, tmax, active), "closest_hit")
    plain_ms = cuda_ms(lambda: isect.closest_hit_reference(
        scene.tris, org, dirn, tmax, active), 1)
    inf = torch.full((B,), float("inf"), device="cuda")
    t_end = torch.where(miss, tmax, torch.nextafter(got["t"], inf))
    need = dense_need(scene, org, dirn, t_end, live=live)
    work = dense_bound(scene, B, 24 + 4 + 1 + 16, need)
    walk = dense_work(got, need)
    from lucille_tpu_torch.kernels.build import library

    regs, spill = isect_registers(library().log)[
        f"closest_hit_kernel<{chunks > 1}>"]
    print(f"[{label}] closest_hit, finite tmax: {int(live.sum())} live rays "
          f"of {B}, {chunks} chunk(s) of {per} supertiles, {hit_rate:.4f} "
          f"of them hit before tmax; tri differs on {differ:.2e} of "
          f"{len(lanes)}, max |t,u,v err| {err:.3e}; kernel {ms:.3f} ms "
          f"({call_ms:.3f} ms a call), plain {plain_ms:.3f} ms, bound "
          f"{work['bound_ms']:.4f} ms ({work['bound_by']}); {walk['text']}; "
          f"{regs} registers, {spill} bytes spilled", flush=True)
    entry = {"scene": label, "tmax": "finite", "chunks": chunks,
             "registers": regs,
             "max_abs_err": err, "ms": ms, "call_ms": call_ms,
             "plain_ms": plain_ms, **walk["numbers"], **work}
    results["closest_hit"].append(entry)
    return entry


def check_tmax_kernels(results):
    """Phase 15: kernel 1 with a finite tmax (the dirt map's gather).
    First at the gather's shape: the bundled scene's first 240x240 tile
    at 3x3 (518,400 rays from the shading points, stratum 7's directions
    of an 8x8 gather, tmax the gather distance, the eye hits live); then
    on the split path: the n = 258 terrain's first tile (6,400 eye rays
    on 1,033 tiles) with a random finite tmax.  Returns the gather's
    entry."""
    import torch

    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.accel.gather import scan_dirs
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.transport.ao import shading_frame

    r = Renderer(bundled_state(640, 480, 3, 64, sunsky=False,
                               method="dirtmap").scene,
                 tile_size=TILE, device="cuda")
    scene = r.scene
    org, dirn, x0, y0 = first_tile_rays(r)
    B = org.shape[0]
    res = closest_hit(scene, org, dirn)
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    d = scene.bbox_max - scene.bbox_min
    gather_dist = 0.25 * torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    si = 7  # a stratum near the horizon: its rays meet the most occluders
    wdir = scan_dirs(b0, b1, b2, r.sampler(x0, y0).uniform((si,), (B, 2)),
                     si, 8, 8)
    entry = check_tmax_kernel("dirtmap-gather", scene, P_off, wdir,
                              gather_dist.expand(B).contiguous(),
                              res["hit"], 65536, results)

    r = Renderer(heightfield_state(258, 80, 60, pixelsamples=2, gather=16,
                                   accel="pallas").scene,
                 tile_size=40, device="cuda")
    org, dirn, _x0, _y0 = first_tile_rays(r)
    B = org.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    d = r.scene.bbox_max - r.scene.bbox_min
    diag = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    tmax = 2.0 * diag * torch.rand(B, device="cuda", generator=gen)
    got = check_tmax_kernel("heightfield258-scan-tmax", r.scene, org, dirn,
                            tmax, None, 2048, results)
    if got["chunks"] < 2:
        raise AssertionError("the scan's tile did not split the range")
    return entry


def check_frame_twins(label, make_state, tile=32, mean_range=(0.1, 1.0)):
    """Phase 12's check of one 80x60 frame: the frame on the card against
    the same frame on the CPU (the plain twins), one numpy stream fed to
    both (HostSampler): ray counts within 1e-3, pixels within 1e-3 on all
    but 1% (relative to max(|value|, 1) where the mean range allows
    radiance above 1); the CPU frame's mean inside mean_range.  Returns
    the card's frame."""
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import HostSampler

    frames = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(make_state().scene, tile_size=tile, device=dev,
                     sampler=HostSampler(0, dev))
        frames[dev] = (r.render_frame(), r.stats.nrays)
    (got, n_got), (ref, n_ref) = frames["cuda"], frames["cpu"]
    off = (np.abs(got - ref) > 1e-3 * np.maximum(np.abs(ref), 1.0)).mean()
    print(f"[{label}] 80x60 on the card against the CPU: {n_got} and "
          f"{n_ref} rays, means {got.mean():.5f} and {ref.mean():.5f}, "
          f"pixels off by > 1e-3: {off:.5f} (<= 0.01)", flush=True)
    if abs(n_got - n_ref) > 1e-3 * n_ref or off > 0.01 or not (
            mean_range[0] < ref.mean() < mean_range[1]):
        raise AssertionError(f"{label}: the card's frame disagrees with the "
                             "plain twins'")
    return got


def check_dirtmap_frames(gather_entry):
    """Phase 16: the dirt map at full width, with phase 4's checks: the
    bundled scene without its sunsky line at bench.py's headline
    settings on the dense tiles (kernel 1 alone, 1 + 64 launches a tile),
    bench_large's n = 256 terrain on the tile BVH (kernel 4 alone); then
    an 80x60 dirt-map frame of the bundled scene (16 gather rays, so the
    CPU's twins take seconds) against the CPU's twins."""
    from lucille_tpu_torch.render.tiles import tile_list

    r = build_renderer("bundled-dirtmap", lambda: bundled_state(
        640, 480, 3, 64, sunsky=False, method="dirtmap"), TILE)
    got, _, _ = render_checked("bundled-dirtmap", r,
                               "chip_smoke_bundled_dirtmap.hdr",
                               ("closest_hit",))
    opt = r.desc.options
    n_tiles = len(tile_list(opt.width, opt.height, TILE, opt.bucket_order))
    per_tile = 1 + opt.gather_nsamples  # the eye rays, then each stratum
    if got["closest_hit"] != n_tiles * per_tile:
        raise AssertionError(f"bundled-dirtmap: {got['closest_hit']} "
                             f"launches of kernel 1, not {n_tiles} x "
                             f"{per_tile}")
    gather_entry["frame_launches"] = got["closest_hit"]
    render_checked("heightfield256-dirtmap", build_renderer(
        "heightfield256-dirtmap",
        lambda: heightfield_state(256, method="dirtmap"), 128),
        "chip_smoke_heightfield256_dirtmap.hdr", ("bvh_closest_hit",))
    check_frame_twins("dirtmap-twins", lambda: bundled_state(
        80, 60, gather=16, sunsky=False, method="dirtmap"))


def check_dof_frames():
    """Phase 17: the bundled scene under DOF_LINE (thin-lens eye rays, the
    lens samples from the tile's stream) at the headline settings as AO,
    with phase 4's checks; then the 80x60 frame against the CPU's."""
    render_checked("bundled-dof", build_renderer(
        "bundled-dof", lambda: bundled_state(640, 480, 3, 64, sunsky=False,
                                             dof=True), TILE),
        "chip_smoke_bundled_dof.hdr", ("closest_hit", "ao_occlusion"))
    check_frame_twins("dof-twins", lambda: bundled_state(
        80, 60, sunsky=False, dof=True))


def check_textured_frames():
    """Phase 18: lucille's texcoord scene at 640x480, 3x3, 64 rays, its
    1024x1024 checker written at run time by the port's write_tex and
    write_exr: the frame through the .tex with phase 4's checks, the dark
    and the bright squares both on it; the atlas loaded from the .exr
    equal to the one from the .tex; then the 80x60 frame (through the
    .exr) against the CPU's."""
    import torch

    r = build_renderer("textured-ao", lambda: textured_state(640, 480), TILE)
    _, _, img = render_checked("textured-ao", r,
                               "chip_smoke_textured_ao.hdr",
                               ("closest_hit", "ao_occlusion"))
    lum = img.mean(-1)
    bright, dark = (lum > 0.5).mean(), ((lum < 0.2) & (lum >= 0)).mean()
    print(f"[textured-ao] bright pixels {bright:.4f}, dark {dark:.4f} "
          "(each > 0.1)", flush=True)
    if not (bright > 0.1 and dark > 0.1):
        raise AssertionError("textured-ao: the checker does not show")
    from lucille_tpu_torch.render.renderer import Renderer

    exr = Renderer(textured_state(16, 16, "checker.exr").scene,
                   tile_size=16, device="cuda").textures
    if not torch.equal(exr.data, r.textures.data):
        raise AssertionError("textured-ao: the .exr and .tex atlases differ")
    check_frame_twins("textured-twins",
                      lambda: textured_state(80, 60, "checker.exr"))


def check_recover():
    """Phase 19: the headline AO frame with a tile checkpoint, stopped by
    a tile callback that raises on its third tile, then recovered: the
    recovered frame equals the uninterrupted one exactly, only the three
    missing tiles are enqueued (and launch the path's kernels), none
    waits on the card, and the checkpoint is gone afterwards."""
    import torch

    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list

    class Stop(Exception):
        pass

    r = Renderer(bundled_state(640, 480, 3, 64, sunsky=False).scene,
                 tile_size=TILE, device="cuda")
    full = r.render_frame()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "frame.ckpt.npz")
        seen = []

        def stop(x0, y0, tile):
            seen.append((x0, y0))
            if len(seen) == 3:
                raise Stop

        try:
            r.render_frame(tile_cb=stop, checkpoint=ckpt)
        except Stop:
            pass
        else:
            raise AssertionError("recover: the frame was not stopped")
        torch.cuda.synchronize()
        with np.load(ckpt) as data:
            n_done = int(data["done"].sum())
        counts = counters()
        for c in counts.values():
            c.reset()
        enqueued = []
        with no_host_sync(r):
            strict = r._tile

            def spy(*args):
                enqueued.append(args[:2])
                return strict(*args)

            r._tile = spy
            img = r.render_frame(checkpoint=ckpt, recover=True)
        left = os.path.exists(ckpt)
    launches = {k: c.kernel for k, c in counts.items() if c.kernel}
    opt = r.desc.options
    n_tiles = len(tile_list(opt.width, opt.height, TILE, opt.bucket_order))
    left_tiles = n_tiles - n_done
    print(f"[recover] stopped after {n_done} of {n_tiles} tiles; recovered "
          f"with "
          f"{len(enqueued)} enqueued, launches {launches}; equal to the "
          f"uninterrupted frame: {np.array_equal(img, full)}; checkpoint "
          f"left: {left}", flush=True)
    if not (n_done == 3 and len(enqueued) == left_tiles
            and np.array_equal(img, full) and not left
            and launches == {"closest_hit": left_tiles,
                             "ao_occlusion": left_tiles}
            and not any(c.plain for c in counts.values())):
        raise AssertionError("recover: the recovered frame is not the "
                             "uninterrupted one")


def check_cli():
    """Phase 20: the CLI on the card in a subprocess, with this slice's
    flags: the bundled scene as shipped by the dirt map, --maxraydepth 2,
    the OpenEXR display, 16 gather rays; the .exr read back: finite, the
    RIB's size, an AO-like mean."""
    from lucille_tpu_torch.imageio.exr import read_exr

    RiState, parse_rib = front_end()
    s = RiState()
    parse_rib(BUNDLED_RIB.read_text(), s)
    W, H = s.options.width, s.options.height
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "x.exr"
        proc = subprocess.run(
            [sys.executable, "-m", "lucille_tpu_torch.cli", str(BUNDLED_RIB),
             "--method", "dirtmap", "--maxraydepth", "2", "--display",
             "openexr", "-o", str(out), "--gather-rays", "16", "--stats"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli: exit {proc.returncode}\n"
                                 f"{proc.stderr[-4000:]}")
        img = read_exr(out)
    rate = next((l.strip() for l in proc.stdout.splitlines()
                 if "Mrays" in l), "")
    print(f"[cli] --method dirtmap --display openexr: {img.shape}, mean "
          f"{img.mean():.4f}; {rate}", flush=True)
    if not (img.shape == (H, W, 3) and np.isfinite(img).all()
            and 0.0 < img.mean() <= 1.0):
        raise AssertionError(f"cli: bad image {img.shape}")


def ibl_bundled(width, height, sampler="cosweight", name="sky.hdr",
                kind="ibl", pixelsamples=None, method="whitted", **kw):
    """The bundled scene with its sunsky line replaced by an environment
    light (`ibl_line`), Whitted by default (the RIB's depth, 8)."""
    return bundled_state(width, height, pixelsamples,
                         light=ibl_line(sampler, name, kind), method=method,
                         **kw)


def env_shadow_rays(r, sampler):
    """The first bounce's shadow rays of Renderer r's environment light on
    the scene's first tile, as lights/ibl.py forms them in a Whitted
    frame: (P + N eps, directions, the eye hits live).  importance: the
    first sample's texels, drawn at the tile stream's fold(0) (the
    bounce), fold(1000) (the light), fold(0) (the sample); structured:
    4 SIS directions spread over its luminance layers (every 16th of 64,
    the sun's first), the tile's rays once for each."""
    import torch

    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.transport.common import face_forward, interp_hit

    org, dirn, x0, y0 = first_tile_rays(r)
    res = closest_hit(r.scene, org, dirn)
    h = interp_hit(r.scene, res, org, dirn)
    P_off = h["P"] + face_forward(h["Ns"], dirn) * r.scene.eps
    env, B = r.lights.lights[0].env, org.shape[0]
    if sampler == "importance":
        table = env.importance_table
        key = StreamKey(r.sampler(x0, y0)).fold(0).fold(1000).fold(0)
        idx = torch.clamp(torch.searchsorted(
            table.cdf, key.uniform((B,)).contiguous()), 0,
            table.dirs.shape[0] - 1)
        return P_off, table.dirs[idx], res["hit"]
    sis = env.structured[0]
    dirs = sis[::max(1, len(sis) // 4)][:4]  # across the luminance layers
    return (P_off.repeat(len(dirs), 1),
            dirs.repeat_interleave(B, dim=0).contiguous(),
            res["hit"].repeat(len(dirs)))


def check_env_any_hits(results, n_slice=65536):
    """Phase 21: kernel 2 (dense) and kernel 5 (tile BVH) on this slice's
    shadow rays (`env_shadow_rays`: importance-sampled texels and
    structured directions, which bunch toward the sky's sun) on the
    bundled scene's headline tile and the n = 256 terrain's first tile,
    against their twins on a slice of the live rays (phase 3's
    tolerances: answers equal on all but 1e-4; the slice neither all
    occluded nor all open), with their device times, plain times and
    bounds (dense_need / need_walk, as phases 3 and 7 count them)."""
    import torch

    from lucille_tpu_torch.accel import bvh_isect, isect

    for accel in ("dense", "bvh"):
        for sampler in ("importance", "structured"):
            label = f"{'bundled' if accel == 'dense' else 'heightfield256'}"\
                f"-ibl-{sampler}"
            if accel == "dense":
                r = build_renderer(label, lambda: ibl_bundled(
                    640, 480, sampler, pixelsamples=3), TILE)
            else:
                r = build_renderer(label, lambda: heightfield_state(
                    256, light=ibl_line(sampler), method="whitted"), 128)
            scene = r.scene
            P_off, wi, live = env_shadow_rays(r, sampler)
            R = P_off.shape[0]
            inf = torch.full((R,), float("inf"), device="cuda")
            lanes = torch.nonzero(live)[:, 0]
            lanes = lanes[max(0, len(lanes) // 2 - n_slice // 2):][:n_slice]
            if accel == "dense":
                name = "any_hit"
                res = isect.any_hit(scene, P_off, wi, None, live,
                                    counters=True)
                got = res["occ"]
                ref = isect.any_hit_reference(
                    scene.tris, P_off[lanes], wi[lanes], inf[lanes])["occ"]
                ms, call_ms = hit_kernel_ms(lambda: isect.any_hit(
                    scene, P_off, wi, None, live), "any_hit")
                plain_ms = cuda_ms(lambda: isect.any_hit_reference(
                    scene.tris, P_off, wi, inf, live), 1)
                need = dense_need(scene, P_off, wi, inf, live, got)
                work = dense_bound(scene, R, 24 + 4 + 1 + 1, need)
                walk = dense_work(res, need)
            else:
                name = "bvh_any_hit"
                args = (scene.tris, scene.nodes, P_off, wi)
                kw = {"depth": scene.tree_depth, "leaf_real": scene.leaf_real}
                res = bvh_isect.bvh_any_hit(*args, **kw)
                got = res["occ"] & live
                ref = bvh_isect.bvh_any_hit_reference(
                    scene.tris, P_off[lanes], wi[lanes], inf[lanes])["occ"]
                ms = cuda_ms(lambda: bvh_isect.bvh_any_hit(*args, **kw), 3)
                call_ms = ms
                plain_ms = timed(lambda: bvh_isect.bvh_any_hit_reference(
                    scene.tris, P_off[lanes], wi[lanes], inf[lanes]))[1]
                gen = torch.Generator(device="cuda").manual_seed(13)
                sample = torch.randperm(R, device="cuda",
                                        generator=gen)[:N_NEED]
                need = need_walk(scene.tris, scene.nodes, P_off[sample],
                                 wi[sample], False, scene.tree_depth)
                scale = R / len(sample)
                work = bound(R * (28 + 1) + reached_bytes(need),
                             scale * (need["tests"] * SV_OPS
                                      + need["inner"] * NODE_OPS))
                walk = walk_report(res, need, scale)
            torch.cuda.synchronize()
            frac = (got[lanes] != ref).float().mean().item()
            occ = ref.float().mean().item()
            if torch.any(got[~live]):
                raise AssertionError(f"{label}: a dead ray reports occlusion")
            print(f"[{label}] {name}: {R} shadow rays ({int(live.sum())} "
                  f"live), the slice's {len(lanes)} live rays {occ:.4f} "
                  f"occluded, {frac:.2e} differ; kernel {ms:.3f} ms "
                  f"({call_ms:.3f} ms a call), plain {plain_ms:.3f} ms"
                  f"{' on the slice' if accel == 'bvh' else ''}, bound "
                  f"{work['bound_ms']:.4f} ms ({work['bound_by']}); "
                  f"{walk['text']}", flush=True)
            if frac > 1e-4 or not 0.001 < occ < 0.999:
                raise AssertionError(f"{label} {name}: {frac:.2e} differ, "
                                     f"{occ:.4f} occluded")
            results[name].append(
                {"scene": label, "rays": R, "ms": ms, "call_ms": call_ms,
                 "plain_ms": plain_ms, "max_abs_err": float(frac > 0),
                 "differs": frac, **walk["numbers"], **work})


def check_env_frames(results):
    """Phase 22: this slice's full-width frames with phase 4's checks:
    bundled-ibl-whitted (the headline settings, Whitted at depth 8 under
    the lat-long sky, cosweight: kernels 1 and 2), heightfield256-ibl-
    whitted (bench_large's n = 256 frame under the sky, importance: 4
    and 5) and bundled-pipeline (headline-ao's settings with miefog, the
    background imager and MOSAICdisplace: 1 and 3).  Each frame's
    launches of kernels 2 and 5 go beside phase 21's entries."""
    dense = ("closest_hit", "any_hit")
    got, _, _ = render_checked("bundled-ibl-whitted", build_renderer(
        "bundled-ibl-whitted", lambda: ibl_bundled(640, 480, pixelsamples=3),
        TILE), "chip_smoke_bundled_ibl_whitted.hdr", dense, max_mean=1e4)
    for e in results["any_hit"]:
        if e["scene"].startswith("bundled-ibl"):
            e["frame_launches"] = got["any_hit"]
    bvh = ("bvh_closest_hit", "bvh_any_hit")
    got, _, _ = render_checked("heightfield256-ibl-whitted", build_renderer(
        "heightfield256-ibl-whitted", lambda: heightfield_state(
            256, light=ibl_line("importance"), method="whitted"), 128),
        "chip_smoke_heightfield256_ibl_whitted.hdr", bvh, max_mean=1e4)
    for e in results["bvh_any_hit"]:
        if e["scene"].startswith("heightfield256-ibl"):
            e["frame_launches"] = got["bvh_any_hit"]
    r = build_renderer("bundled-pipeline", lambda: bundled_state(
        640, 480, 3, 64, sunsky=False, head=PIPELINE_IMAGER,
        world=pipeline_world()), TILE)
    if not (r.atmosphere is not None and r.desc.options.imager
            and all(getattr(g, "_displaced", False) for g in r.desc.geoms)):
        raise AssertionError("bundled-pipeline: a stage is not bound")
    render_checked("bundled-pipeline", r, "chip_smoke_bundled_pipeline.hdr",
                   ("closest_hit", "ao_occlusion"), max_mean=10.0)


def check_env_twins():
    """Phase 23: 80x60 frames on the card against the CPU's twins
    (`check_frame_twins`, 1x1 samples): Whitted at --maxraydepth 1 under
    each sampler (bruteforce on the 16x8 sky: 128 shadow wavefronts a
    bounce, on one 80x80 tile), the angular probe, the path tracer under the lat-long sky;
    AO under each atmosphere (16 gather rays), the imager, and
    MOSAICdisplace."""
    for sampler in IBL_SAMPLERS:
        brute = sampler == "bruteforce"

        def make(sampler=sampler, brute=brute):
            s = ibl_bundled(80, 60, sampler,
                            "sky16.hdr" if brute else "sky.hdr",
                            pixelsamples=1)
            s.options.max_ray_depth = 1
            return s

        check_frame_twins(f"ibl-{sampler}-twins", make, 80 if brute else 32,
                          mean_range=(0.1, 1e4))
    check_frame_twins("ibl-angular-twins", lambda: ibl_bundled(
        80, 60, name="probe.hdr", kind="dome", pixelsamples=1),
        mean_range=(0.1, 1e4))
    check_frame_twins("ibl-pathtrace-twins", lambda: ibl_bundled(
        80, 60, pixelsamples=1, method="pathtrace"), mean_range=(0.1, 1e4))
    atmospheres = {
        "fog": 'Atmosphere "fog" "distance" [25.0] "background" [0.5 0.6 0.8]\n',
        "depthcue": 'Atmosphere "depthcue" "mindistance" [12.0] '
                    '"maxdistance" [22.0] "background" [0.4 0.4 0.4]\n',
        "MOSAICfog": 'Atmosphere "MOSAICfog" "isMist" [1] "Sta" [10.0] '
                     '"Di" [25.0] "MistType" [1] "Hi" [3.0] '
                     '"MistCol" [0.7 0.7 0.8]\n',
        "miefog": pipeline_world().splitlines()[0] + "\n",
    }
    for name, line in atmospheres.items():
        check_frame_twins(f"{name}-twins", lambda line=line: bundled_state(
            80, 60, 1, 16, sunsky=False, world=line), mean_range=(0.1, 10.0))
    check_frame_twins("imager-twins", lambda: bundled_state(
        80, 60, 1, 16, sunsky=False, head=PIPELINE_IMAGER))
    check_frame_twins("displace-twins", lambda: bundled_state(
        80, 60, 1, 16, sunsky=False,
        world=pipeline_world().splitlines()[1] + "\n"))


def check_recover_imager():
    """Phase 24: an 80x60 imager frame (the pipeline's stages, 16 gather
    rays, tile 16: 20 tiles) stopped after a third of its tiles and
    recovered on the card: the image and the alpha of its last
    checkpoint (copied as the last tile arrives) equal the uninterrupted
    frame's exactly, and only the missing tiles are enqueued, none
    waiting on the card."""
    import shutil

    import torch

    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list

    class Stop(Exception):
        pass

    def make():
        return Renderer(bundled_state(
            80, 60, 2, 16, sunsky=False, head=PIPELINE_IMAGER,
            world=pipeline_world()).scene, tile_size=16, device="cuda")

    def last_checkpoint(r, ckpt, n_tiles, **kw):
        """(the frame, the image and alpha of its last checkpoint)."""
        seen, keep = [], ckpt + ".last.npz"

        def cb(x0, y0, tile):
            seen.append((x0, y0))
            if len(seen) == n_tiles:
                shutil.copy(ckpt, keep)

        img = r.render_frame(tile_cb=cb, checkpoint=ckpt, **kw)
        with np.load(keep) as data:
            return img, data["image"].copy(), data["alpha"].copy()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "frame.ckpt.npz")
        r = make()
        opt = r.desc.options
        n_tiles = len(tile_list(opt.width, opt.height, 16, opt.bucket_order))
        n_stop = n_tiles // 3
        full, full_img, full_alpha = last_checkpoint(r, ckpt, n_tiles)
        seen = []

        def stop(x0, y0, tile):
            seen.append((x0, y0))
            if len(seen) == n_stop:
                raise Stop

        try:
            make().render_frame(tile_cb=stop, checkpoint=ckpt)
        except Stop:
            pass
        torch.cuda.synchronize()
        r = make()
        enqueued = []
        with no_host_sync(r):
            strict = r._tile

            def spy(*args):
                enqueued.append(args[:2])
                return strict(*args)

            r._tile = spy
            img, ck_img, ck_alpha = last_checkpoint(r, ckpt, n_tiles,
                                                    recover=True)
    ok = (np.array_equal(img, full) and np.array_equal(ck_alpha, full_alpha)
          and np.array_equal(ck_img, full_img)
          and len(enqueued) == n_tiles - n_stop)
    print(f"[recover-imager] stopped after {n_stop} of {n_tiles} tiles; "
          "recovered "
          f"with {len(enqueued)} enqueued; frame, checkpoint image and alpha "
          f"(coverage {full_alpha.mean():.4f}) equal to the uninterrupted "
          f"frame's: {ok}", flush=True)
    if not (ok and 0.0 < full_alpha.mean() < 1.0):
        raise AssertionError("recover-imager: the recovered frame is not the "
                             "uninterrupted one")


def check_socket_display():
    """Phase 25: the CLI's entry point on the card (in this process: phase
    20 runs it in a subprocess), 80x60, --display socket with
    LUCILLE_NO_SPAWN_VIEWER=1, streaming to a SocketListener on a free
    port; the reassembled frame equals the .pfm the same command writes
    with --display file (the file driver flips rows)."""
    from lucille_tpu_torch.cli import main as cli_main
    from lucille_tpu_torch.imageio.loader import load_image

    lis = SocketListener()
    with environ(LUCILLE_NO_SPAWN_VIEWER="1",
                 LUCILLE_SOCKET_PORT=str(lis.port)), \
            tempfile.TemporaryDirectory() as tmp:
        for display in ("socket", "file"):
            rc = cli_main([str(BUNDLED_RIB), "--width", "80", "--height",
                           "60", "--display", display, "-o",
                           f"{tmp}/{display}.pfm"])
            if rc != 0:
                raise AssertionError(f"socket: --display {display} "
                                     f"exit {rc}")
        lis.join()
        want = load_image(f"{tmp}/file.pfm")[::-1]
        wrote = os.path.exists(f"{tmp}/socket.pfm")
    same = lis.frame is not None and np.array_equal(lis.frame, want)
    print(f"[socket] --display socket streamed {len(lis.raw)} bytes "
          f"({'FINISH' if lis.finished else 'no FINISH'}), frame "
          f"{None if lis.frame is None else lis.frame.shape}, mean "
          f"{want.mean():.4f}; equal to --display file's frame: {same}",
          flush=True)
    if not (same and lis.finished and not wrote and want.mean() > 1.0):
        raise AssertionError("socket: the streamed frame is not the file's")


def check_shader_frames():
    """Phase 26: the shader method's full-width frames with phase 4's
    checks (module docstring), each with one profiled frame's device
    ops, busy and idle share; the launches of each path kernel must be
    the count its path makes, and the rays lucille_tpu's count (B a
    tile: it counts a wavefront's own rays, not trace()'s)."""
    from profile_frame import frame_profile

    from lucille_tpu_torch.render.tiles import tile_list

    frames = (
        ("bundled-shader-sl", shader_sl_state, TILE,
         ("closest_hit", "any_hit"), lambda nl: (15, 15 * nl)),
        ("bundled-shader-ao", shader_ao_state, TILE,
         ("closest_hit", "any_hit"), lambda nl: (1, 64)),
        ("heightfield256-shader", shader_hf_state, 128,
         ("bvh_closest_hit", "bvh_any_hit"), lambda nl: (1, 2 * nl)),
    )
    for label, make_state, tile, path, per_tile in frames:
        r = build_renderer(label, make_state, tile)
        got, best, _img = render_checked(label, r,
                                         f"chip_smoke_{label}.hdr", path)
        nrays = r.stats.nrays  # the last timed frame's
        opt = r.desc.options
        n_tiles = len(tile_list(opt.width, opt.height, tile,
                                opt.bucket_order))
        want = tuple(n_tiles * k for k in per_tile(len(r.lights.lights)))
        S = int(opt.current_display().sampling_rates[0]) * int(
            opt.current_display().sampling_rates[1])
        rays = n_tiles * tile * tile * S
        p = frame_profile(r, 1)
        print(f"[{label}] launches {got} (the path's count: "
              f"{dict(zip(path, want))}); {nrays} rays "
              f"(lucille_tpu's count: {rays}); profiled frame "
              f"{p['wall_ms']:.2f} ms, device busy {p['busy_ms']:.2f} ms, "
              f"idle share {p['idle']:.3f}, {p['ops']} device ops, "
              f"{p['syncs']} host syncs", flush=True)
        for name, (ms, n) in sorted(p["by_name"].items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
        for k in path:  # the path kernels' device time in that frame
            ms, n = (sum(v[i] for name, v in p["by_name"].items()
                         if SYMBOLS[k] in name) for i in (0, 1))
            print(f"  {k}: {n} launches, {ms:.3f} ms "
                  f"({ms / max(n, 1):.4f} ms a launch)", flush=True)
        if tuple(got[k] for k in path) != want:
            raise AssertionError(f"{label}: launches {got}, not {want}")
        if nrays != rays:
            raise AssertionError(f"{label}: {nrays} rays, not {rays}")


def check_shader_twins():
    """Phase 27: 80x60 frames under the shader method on the card
    against the CPU's twins (`check_frame_twins`, 1x1 samples): the six
    built-in surfaces and whitted.sl on the scene as shipped, the
    illuminance surface under a point and under an area light, the
    noise() surface, the uniform-Ci and computed-triple surfaces, each
    also rendered as a new Renderer's first frame with no tile waiting on
    the card; then AO frames (16 gather rays) under each .sl stage: the
    displacement, the atmosphere, the imager."""
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import HostSampler

    def twins_and_first_frame(label, make_state, mean_range):
        check_frame_twins(label, make_state, mean_range=mean_range)
        r = Renderer(make_state().scene, tile_size=32, device="cuda")
        with no_host_sync(r):
            img = r.render_frame()
        if not np.isfinite(img).all():
            raise AssertionError(f"{label}: the first frame is not finite")

    wide = (0.01, 1e6)  # the sky's radiance on the escaped pixels
    for name in ("matte", "constant", "plastic", "checker",
                 "ambientocclusion", "mirror", "whitted", "noisy",
                 "flatred", "constred", "tinted"):
        twins_and_first_frame(f"shader-{name}-twins", lambda name=name: (
            bundled_state(80, 60, 1, head=shader_head(),
                          world=f'Surface "{name}"\n', method="shader")),
            wide)
    for light, line in (("point", POINT_LIGHT), ("area", AREA_LIGHT)):
        twins_and_first_frame(
            f"shader-lambert-{light}-twins", lambda line=line: (
                bundled_state(80, 60, 1, light=line, head=shader_head(),
                              world='Surface "lambert"\n',
                              method="shader")),
            (0.01, 10.0))

    plain = Renderer(bundled_state(80, 60, 1, 16, sunsky=False).scene,
                     tile_size=32, device="cuda",
                     sampler=HostSampler(0, "cuda")).render_frame()
    stages = {"displace": ("", 'Displacement "bumps" "amp" [0.08]\n'),
              "atmosphere": ("", 'Atmosphere "haze" "d" [25]\n'),
              "imager": ('Imager "vignette"\n', "")}
    for name, (head, world) in stages.items():
        got = check_frame_twins(f"sl-{name}-twins", lambda head=head,
                                world=world: bundled_state(
            80, 60, 1, 16, sunsky=False, head=shader_head() + head,
            world=world), mean_range=(0.05, 10.0))
        moved = float(np.abs(got - plain).max())
        print(f"[sl-{name}-twins] the stage moves the frame by up to "
              f"{moved:.4f}", flush=True)
        if moved < 0.01:
            raise AssertionError(f"sl-{name}: the stage was not applied")


def check_shader_cli():
    """Phase 28: the CLI's entry point in this process, --method shader
    on the whitted.sl scene at 160x120 into an .hdr, equal to the
    Renderer's frame written through the same driver (both with the
    default stream, seed 0)."""
    from lucille_tpu_torch.cli import main as cli_main
    from lucille_tpu_torch.display.drivers import get_display_driver
    from lucille_tpu_torch.imageio.rgbe import read_hdr
    from lucille_tpu_torch.render.renderer import Renderer

    with tempfile.TemporaryDirectory() as tmp:
        rib = Path(tmp) / "whitted.rib"
        rib.write_text(BUNDLED_RIB.read_text().replace(
            "WorldBegin\n", shader_head() + 'WorldBegin\nSurface "whitted"\n',
            1))
        rc = cli_main([str(rib), "--method", "shader", "--width", "160",
                       "--height", "120", "--pixelsamples", "2", "--tile",
                       "64", "-o", f"{tmp}/cli.hdr"])
        if rc != 0:
            raise AssertionError(f"shader-cli: exit {rc}")
        s = shader_sl_state(160, 120, 2)
        r = Renderer(s.scene, tile_size=64, device="cuda")
        drv = get_display_driver("file")
        drv.open(f"{tmp}/renderer.hdr", 160, 120)
        r.render_frame(tile_cb=drv.write)
        drv.close()
        got, want = read_hdr(f"{tmp}/cli.hdr"), read_hdr(f"{tmp}/renderer.hdr")
    same = np.array_equal(got, want)
    print(f"[shader-cli] --method shader: {got.shape}, mean {got.mean():.4f}"
          f"; equal to the Renderer's frame: {same} (max diff "
          f"{np.abs(got - want).max():.3g})", flush=True)
    if not (same and got.shape == (120, 160, 3) and got.mean() > 1.0):
        raise AssertionError("shader-cli: the CLI's frame is not the "
                             "Renderer's")


GRID_PATH = ("grid_closest_hit", "grid_any_hit")
# a grid walk's entry (csrc/ugrid.cu: the slab test against the grid's
# box, the entry cell, the steps and boundary distances of three axes)
GRID_ENTRY_OPS = 70


def grid_registers(log: str) -> dict:
    """{"grid_kernel<any, lanes, counters>": (registers, stack frame
    bytes)} of csrc/ugrid.cu's entries (a closest hit and an any-hit for
    each group of lanes a ray and each counter level); raises if one is
    missing, spills or keeps a stack frame (the walk's per-axis state
    belongs in registers)."""
    import re

    stacks, name = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
            continue
        m = name and re.search(r"(\d+) bytes (stack frame|cumulative stack)",
                               line)
        if m:
            stacks[name] = max(stacks.get(name, 0), int(m.group(1)))
        if "Used " in line:
            name = None
    out = {}
    for name, (regs, spill) in ptxas_entries(log).items():
        m = re.search(r"grid_kernelILb([01])ELi(\d+)ELi(\d+)EE", name)
        if m:
            if spill or stacks.get(name, 0):
                raise AssertionError(f"ugrid.cu {name}: {spill} bytes "
                                     f"spilled, {stacks.get(name)} bytes of "
                                     "stack frame")
            key = (f"grid_kernel<{bool(int(m.group(1)))}, {m.group(2)}, "
                   f"{m.group(3)}>")
            out[key] = (regs, stacks.get(name, 0))
    if {k.split(",")[0] for k in out} != {"grid_kernel<False",
                                          "grid_kernel<True"}:
        raise AssertionError(f"ugrid.cu: an entry's report missing: {out}")
    return out


def grid_bound(got, reads, B: int, live: int, tmax: bool, active: bool,
               any_hit: bool) -> dict:
    """The least time for a grid walk of B rays, `live` of them walking:
    its own counted work as operations (each tested slot a
    Moller-Trumbore test, each cell advance DDA_OPS, each live ray's
    entry GRID_ENTRY_OPS); as bytes, the inputs it was passed read once
    (a live ray's origin and direction, its tmax where one was passed,
    every ray's active byte where a mask was passed), the grid and
    triangle entries the walk reads once (`reads`, the twin's distinct
    CSR offsets, slots and tested triangles: 4, 4 and 36 bytes), and its
    outputs written once (t, u, v, tri; or one occlusion byte)."""
    ops = (int(got["ntests"]) * MT_OPS + int(got["ntrav"]) * DDA_OPS
           + live * GRID_ENTRY_OPS)
    nbytes = (live * (24 + (4 if tmax else 0)) + (B if active else 0)
              + B * (1 if any_hit else 16)
              + 4 * int(reads["cell_start"].sum() + reads["tri_idx"].sum())
              + 36 * int(reads["tris"].sum()))
    return bound(nbytes, ops)


def _check_grid_equal(label, got, ref, keys) -> float:
    """Every key of the kernel's result equal to the twin's, exactly;
    returns max |t - t_twin| over the hits (0 when exact)."""
    import torch

    for k in keys:
        if not torch.equal(got[k], ref[k]):
            raise AssertionError(f"{label}: {k} differs from the twin")
    if "t" not in got:
        return 0.0
    hit = ref["tri"] >= 0
    return float((got["t"][hit] - ref["t"][hit]).abs().max())


def check_grid_kernels(label, r, results, log):
    """Phase 29 for one scene: the grid walk's entry points
    (csrc/ugrid.cu) against the lock-step twin on the scene's first tile:
    the closest hit on its eye rays, the any-hit on the AO scan's
    stratum 7 of 64 (the most grazing of the first row) of gather rays
    from their hits (the missed lanes dead); tri, t, u, v, occlusion,
    ntests and ntrav equal exactly, both from the launch that also counts
    the warps' own steps and from the entries as the render paths call
    them (`closest_hit` with its counters, `any_hit` without), the calls
    that are timed; ms a launch (CUDA events, 10 launches), the twin's ms
    (one run), the bound (from the launch's counters and the twin's
    record of the walk's reads), registers and spills.  Appends to
    results[name]."""
    from lucille_tpu_torch.accel import ugrid
    from lucille_tpu_torch.accel.gather import scan_dirs
    from lucille_tpu_torch.transport.ao import shading_frame

    scene = r.scene
    if scene.accel != "ugrid":
        raise AssertionError(f"{label}: accel {scene.accel}")
    regs = grid_registers(log)
    org, dirn, x0, y0 = first_tile_rays(r)
    B = org.shape[0]
    lanes = ugrid.group_lanes(scene, B)
    closest_keys = ("tri", "t", "u", "v", "ntests", "ntrav")
    # with the warps' own steps (an instantiation of its own)
    got = ugrid.grid_walk_kernel(scene, org, dirn)
    reads = {}
    ref = ugrid.grid_walk_reference(scene, org, dirn, reads=reads)
    err = _check_grid_equal(f"{label} closest", got, ref, closest_keys)
    _, plain_ms = timed(lambda: ugrid.grid_walk_reference(scene, org, dirn))
    # each entry as the render paths launch it, the one timed: the
    # closest hit with its rays' counters, the any-hit with none
    err = max(err, _check_grid_equal(
        f"{label} closest_hit", ugrid.closest_hit(scene, org, dirn), ref,
        closest_keys))
    ms = cuda_ms(lambda: ugrid.closest_hit(scene, org, dirn), 10)
    hit = got["tri"] >= 0
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, {**got, "hit": hit})
    wdir = scan_dirs(b0, b1, b2, r.sampler(x0, y0).uniform((7,), (B, 2)),
                     7, 8, 8)
    occ = ugrid.grid_walk_kernel(scene, P_off, wdir, None, hit, any_hit=True)
    any_reads = {}
    occ_ref = ugrid.grid_walk_reference(scene, P_off, wdir, None, hit,
                                        any_hit=True, reads=any_reads)
    _check_grid_equal(f"{label} any", occ, occ_ref,
                      ("occ", "ntests", "ntrav"))
    _check_grid_equal(f"{label} any_hit",
                      ugrid.any_hit(scene, P_off, wdir, None, hit), occ_ref,
                      ("occ",))
    _, plain_any_ms = timed(lambda: ugrid.grid_walk_reference(
        scene, P_off, wdir, None, hit, any_hit=True))
    any_ms = cuda_ms(lambda: ugrid.any_hit(scene, P_off, wdir, None, hit),
                     10)
    n_hit, n_occ = int(hit.sum()), int(occ["occ"].sum())
    for name, res, rd, k_ms, p_ms, any_hit, live, reg in (
            ("grid_closest_hit", got, reads, ms, plain_ms, False, B,
             f"grid_kernel<False, {lanes}, 1>"),
            ("grid_any_hit", occ, any_reads, any_ms, plain_any_ms, True,
             n_hit, f"grid_kernel<True, {lanes}, 0>")):
        # the closest hit is passed neither tmax nor a mask, the any-hit
        # the eye hits as its mask and no tmax
        b = grid_bound(res, rd, B, live, False, any_hit, any_hit)
        # SIMT efficiency: lanes busy over lanes issued, in the advance
        # loop (a ray's advance keeps its group's lanes busy) and in the
        # chunk steps (up to K slots a lane)
        w_trav, w_tests = int(res["warp_ntrav"]), int(res["warp_ntests"])
        # the lock-step twin's walk, counted (not timed): each walking
        # ray's steps (a chunk of K slots or an advance), and the share of
        # advances that enter a cell listing no slot
        walked = rd["steps"][rd["steps"] > 0].double()
        entry = {"scene": label, "rays": B, "live": live,
                 "max_abs_err": err if not any_hit else 0.0, "ms": k_ms,
                 "plain_ms": p_ms, **b, "ntests": int(res["ntests"]),
                 "ntrav": int(res["ntrav"]), "warp_ntrav": w_trav,
                 "warp_ntests": w_tests, "lanes": lanes,
                 "simt_advance": lanes * int(res["ntrav"]) / max(32 * w_trav,
                                                                 1),
                 "simt_chunk": int(res["ntests"]) / max(32 * ugrid.K
                                                        * w_tests, 1),
                 "twin_steps_mean": float(walked.mean()),
                 "twin_steps_max": int(walked.max()),
                 "twin_empty_share": int(rd["empty"].sum())
                 / max(int(res["ntrav"]), 1),
                 "registers": regs[reg][0], "res": scene.grid_res}
        results[name].append(entry)
        print(f"[{label}] {name}: {B} rays ({live} live; {n_hit} eye hits, "
              f"{n_occ} gather rays occluded), grid {scene.grid_res}^3, "
              f"{scene.n_tris} triangles, {lanes} lanes a ray; equal to "
              f"the twin (tri, t, u, v / occlusion, ntests "
              f"{entry['ntests']}, ntrav {entry['ntrav']}); "
              f"{k_ms:.3f} ms a launch, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{entry['ntests'] / max(live, 1):.1f} slots tested and "
              f"{entry['ntrav'] / max(live, 1):.1f} advances a live ray), "
              f"twin {p_ms:.3f} ms; warp steps {w_trav} advance / "
              f"{w_tests} chunk, SIMT efficiency "
              f"{entry['simt_advance']:.3f} / {entry['simt_chunk']:.3f}; "
              f"the twin's walk (counts): {entry['twin_steps_mean']:.1f} "
              f"steps a walking ray (longest {entry['twin_steps_max']}), "
              f"{entry['twin_empty_share']:.2f} of the advances into an "
              f"empty cell; "
              f"{regs[reg][0]} registers, no spill, no stack frame",
              flush=True)


def check_accel_frames(results):
    """Phase 30: the full-width frames of the grid, the dense requests
    and the re-binned gather with phase 4's checks,
    each with its launches against its path's count, its rays against the
    same scene's frame on its default accel (lucille_tpu's count: the eye
    rays and S gather rays a hit; the accels find the same hits), and one
    profiled frame's device ops, busy and idle share: headline-ao-grid
    and heightfield256-grid (the grid: one closest hit and 64 any-hits a
    tile), headline-ao-bruteforce and headline-ao-mxu (lucille_tpu's
    requests on the dense tiles: kernel 1, then kernel 2 on each of the 64
    strata), heightfield256-rebinned (the tile BVH under
    LUCILLE_BVH_AO=rebinned: kernel 4, then kernel 5 once a tile on the
    4,194,304 sorted gather rays).  Returns the grid frame's launches."""
    from profile_frame import frame_profile

    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list

    dense = ("closest_hit", "any_hit")
    bvh = ("bvh_closest_hit", "bvh_any_hit")
    headline = lambda **kw: bundled_state(640, 480, 3, 64,  # noqa: E731
                                          sunsky=False, **kw)
    frames = (
        ("headline-ao-grid", lambda: headline(accel="grid"), TILE, "cone",
         GRID_PATH, (1, 64), "bundled"),
        ("heightfield256-grid", lambda: heightfield_state(256, accel="grid"),
         128, "cone", GRID_PATH, (1, 64), "hf"),
        ("headline-ao-bruteforce", lambda: headline(accel="bruteforce"),
         TILE, "cone", dense, (1, 64), "bundled"),
        ("headline-ao-mxu", lambda: headline(accel="mxu"), TILE, "cone",
         dense, (1, 64), "bundled"),
        ("heightfield256-rebinned", lambda: heightfield_state(256), 128,
         "rebinned", bvh, (1, 1), "hf"),
    )
    ref_rays = {}
    for kind, make_state, tile in (("bundled", headline, TILE),
                                   ("hf", lambda: heightfield_state(256),
                                    128)):
        r = Renderer(make_state().scene, tile_size=tile, device="cuda")
        r.render_frame()
        ref_rays[kind] = r.stats.nrays
    grid_launches = None
    for label, make_state, tile, mode, path, per_tile, kind in frames:
        r = build_renderer(label, make_state, tile)
        with bvh_ao_mode(mode):
            got, _best, _img = render_checked(label, r,
                                              f"chip_smoke_{label}.hdr", path)
            nrays = r.stats.nrays  # the last timed frame's
            p = frame_profile(r, 1)
        opt = r.desc.options
        n_tiles = len(tile_list(opt.width, opt.height, tile,
                                opt.bucket_order))
        want = tuple(n_tiles * k for k in per_tile)
        print(f"[{label}] launches {got} (the path's count: "
              f"{dict(zip(path, want))}); {nrays} rays (the default "
              f"accel's frame: {ref_rays[kind]}); profiled frame "
              f"{p['wall_ms']:.2f} ms, device busy {p['busy_ms']:.2f} ms, "
              f"idle share {p['idle']:.3f}, {p['ops']} device ops, "
              f"{p['syncs']} host syncs", flush=True)
        for name, (ms, n) in sorted(p["by_name"].items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            print(f"  {ms:9.3f} ms  {n:5d}x  {ms / n:.4f} ms a launch  "
                  f"{name[:90]}")
        if tuple(got[k] for k in path) != want:
            raise AssertionError(f"{label}: launches {got}, not {want}")
        if abs(nrays - ref_rays[kind]) > 1e-5 * ref_rays[kind]:
            raise AssertionError(f"{label}: {nrays} rays, not "
                                 f"{ref_rays[kind]}")
        if label == "headline-ao-grid":
            grid_launches = got
            for k in GRID_PATH:
                results[k][0]["frame_launches"] = got[k]
    return grid_launches


def check_accel_twins():
    """Phase 31: 80x60 frames of phase 30's paths on the card against
    the CPU's twins (`check_frame_twins`, phase 12's bound): AO (16 rays)
    and Whitted (depth 2) on the grid, AO under the bruteforce and mxu
    requests, and the re-binned gather on the 35x35 heightfield's tile
    BVH (80x60, 1x1, 16 rays)."""
    def bundled(accel, method=None):
        def make():
            s = bundled_state(80, 60, 1, 16, sunsky=False, accel=accel,
                              method=method)
            s.options.max_ray_depth = 2
            return s
        return make

    check_frame_twins("grid-ao-twins", bundled("grid"))
    check_frame_twins("grid-whitted-twins", bundled("grid", "whitted"))
    check_frame_twins("bruteforce-ao-twins", bundled("bruteforce"))
    check_frame_twins("mxu-ao-twins", bundled("mxu"))
    with bvh_ao_mode("rebinned"):
        check_frame_twins("rebinned-ao-twins", lambda: heightfield_state(
            35, 80, 60, pixelsamples=1, gather=16, accel="bvh"))


def check_inverse_render():
    """Phase 32: inverse rendering on the card at full width, the
    inverse-render example's scene at 640x480, 4 samples, depth 3, path
    traced: one forward and one backward pass timed (host clock and a
    synchronize) with the peak memory torch allocated over them; five
    Adam steps on mat_kd and mat_color from the example's start (each
    step's seconds), the loss falling; then at 80x60 every parameter's
    gradient of the L2 loss on the card against the CPU's twins, one
    numpy stream fed to both: within 1e-3 of the largest |gradient| of
    that parameter (phase 12's bound; cos and sin in the bounce
    directions round differently on the two devices)."""
    import torch

    from lucille_tpu_torch.diff import render_loss_and_grad
    from lucille_tpu_torch.examples.inverse_render import (
        TRUE_COLOR,
        TRUE_KD,
        recover,
        setup,
    )
    from lucille_tpu_torch.sampling.jitter import HostSampler, TileSampler

    render_fn, params = setup(640, 480, "cuda", spp=4, max_depth=3)
    dev = params["mat_kd"].device
    stream = TileSampler(0, dev)(0, 0)
    true = {**params, "mat_kd": torch.tensor(TRUE_KD, device=dev),
            "mat_color": torch.tensor(TRUE_COLOR, device=dev)}
    with torch.no_grad():
        target = render_fn(true, stream)
    start = {"mat_kd": torch.full((2,), 0.6, device=dev),
             "mat_color": torch.full((2, 3), 0.5, device=dev)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    img = render_fn({**params, **leaves}, stream)
    loss = torch.mean((img - target) ** 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    steps = []

    def log(_i, _loss):
        torch.cuda.synchronize()
        steps.append(time.perf_counter())

    t3 = time.perf_counter()
    _theta, losses = recover(render_fn, params, target, stream, start, 5,
                             log=log)
    step_s = [b - a for a, b in zip([t3] + steps[:-1], steps)]
    print(f"[inverse-render] 640x480, 4 samples, depth 3: forward "
          f"{t1 - t0:.4f} s, backward {t2 - t1:.4f} s, peak memory "
          f"{(peak - base) / 2**30:.3f} GiB above {base / 2**30:.3f} GiB "
          f"({peak / 2**30:.3f} GiB in all); 5 Adam steps "
          f"{[round(s, 4) for s in step_s]} s, loss "
          f"{[round(v, 6) for v in losses]}", flush=True)
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise AssertionError(f"inverse-render: the loss did not fall: "
                             f"{losses}")

    grads = {}
    for d in ("cuda", "cpu"):
        fn, ps = setup(80, 60, d, spp=4, max_depth=3)
        st = HostSampler(0, d)(0, 0)
        with torch.no_grad():
            tgt = fn({**ps, "mat_kd": torch.tensor(
                TRUE_KD, device=ps["mat_kd"].device)}, st)
        grads[d] = render_loss_and_grad(fn, tgt, ps, st)
    worst = 0.0
    for k, g in grads["cpu"][1].items():
        scale = max(float(g.abs().max()), 1e-6)
        err = float((grads["cuda"][1][k].cpu() - g).abs().max()) / scale
        worst = max(worst, err)
    loss_err = abs(float(grads["cuda"][0]) - float(grads["cpu"][0]))
    print(f"[inverse-render] 80x60 gradients on the card against the CPU: "
          f"worst |difference| / max |gradient| {worst:.3g} (<= 1e-3); "
          f"losses {float(grads['cuda'][0]):.6g} and "
          f"{float(grads['cpu'][0]):.6g}", flush=True)
    if worst > 1e-3 or loss_err > 1e-3 * float(grads["cpu"][0]):
        raise AssertionError("inverse-render: the card's gradients disagree "
                             "with the CPU's")


def check_library_paths():
    """Phase 33: single_scattering on the headline tile's hit lanes (the
    bundled scene under a point and a distant light, dense tiles, kernel
    2 for its shadow rays), the card against the CPU's twins on 65,536 of
    them with one numpy stream: within 1e-4 of max(|value|, 1e-3) on all
    but 1% of the lanes; its time on all the tile's hit lanes; then
    tools/bvh_viz.py's traversal counters and heatmap of the bundled
    scene at 160x120 on the card, equal to the CPU's."""
    import torch

    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import HostStream, StreamKey
    from lucille_tpu_torch.tools import bvh_viz
    from lucille_tpu_torch.transport.common import interp_hit
    from lucille_tpu_torch.transport.sss import single_scattering

    def state():
        return bundled_state(640, 480, 3, light=POINT_LIGHT + DISTANT_LIGHT)

    r = Renderer(state().scene, tile_size=TILE, device="cuda")
    org, dirn, _x0, _y0 = first_tile_rays(r)
    res = closest_hit(r.scene, org, dirn)
    h = interp_hit(r.scene, res, org, dirn)
    live = res["hit"]
    P, N, I = h["P"][live], h["Ns"][live], dirn[live]
    n = P.shape[0]
    key = StreamKey(HostStream(0, 0, 0, "cuda"))
    _full, ms = timed(lambda: single_scattering(r.scene, r.lights, P, N, I,
                                                key))
    m = min(n, 65536)
    got = single_scattering(r.scene, r.lights, P[:m], N[:m], I[:m],
                            key).cpu().numpy()
    rc = Renderer(state().scene, tile_size=TILE, device="cpu")
    ref = single_scattering(rc.scene, rc.lights, P[:m].cpu(), N[:m].cpu(),
                            I[:m].cpu(),
                            StreamKey(HostStream(0, 0, 0, "cpu"))).numpy()
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)
    off = float((err > 1e-4).any(axis=1).mean())
    print(f"[sss] single_scattering on {n} hit lanes: {ms:.3f} ms; on "
          f"{m} of them against the CPU's twins: lanes off by > 1e-4 "
          f"{off:.5f} (<= 0.01), mean {ref.mean():.5f}", flush=True)
    if off > 0.01 or not ref.mean() > 0 or not np.isfinite(got).all():
        raise AssertionError("sss: the card disagrees with the twins")

    stats = {d: bvh_viz.render_diag(BUNDLED_RIB, 160, 120, "nvisits",
                                    device=d)[1] for d in ("cuda", "cpu")}
    same = all(np.array_equal(stats["cuda"][k], stats["cpu"][k])
               for k in stats["cpu"])
    print(f"[bvh-viz] 160x120 node visits {int(stats['cuda']['nvisits'].min())}"
          f"-{int(stats['cuda']['nvisits'].max())}, triangle tests up to "
          f"{int(stats['cuda']['ntris'].max())}; equal to the CPU's: {same}",
          flush=True)
    if not same or not np.array_equal(
            bvh_viz.heatmap(stats["cuda"]["nvisits"]),
            bvh_viz.heatmap(stats["cpu"]["nvisits"])):
        raise AssertionError("bvh-viz: the card's counters differ")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_ranks(argvs, timeout: float, prefix=("-m", "lucille_tpu_torch.cli"),
              env=None):
    """The CLI (python `prefix` argv) once per argv, as ranks 0, 1, ... of
    one torch.distributed group on a free local port, all started
    together; again on another port if the first was taken between its
    pick and its bind.  Returns (each rank's stdout, wall seconds).
    Raises on a non-zero exit, or when a rank outlives `timeout` seconds
    (every rank is killed)."""
    for attempt in range(2):
        port = free_port()
        logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
                for _ in argvs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, *prefix, *argv, "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(len(argvs)),
             "--process-id", str(rank)],
            cwd=ROOT, env=env, stdout=out, stderr=err, text=True)
            for rank, (argv, (out, err)) in enumerate(zip(argvs, logs))]
        try:
            for proc in procs:
                proc.wait(timeout=max(timeout - (time.perf_counter() - t0),
                                      1.0))
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
        taken = any("EADDRINUSE" in e or "address already in use" in e
                    for _o, e in texts)
        if attempt == 0 and taken:
            continue
        for rank, (proc, (_o, e)) in enumerate(zip(procs, texts)):
            if proc.returncode != 0:
                raise AssertionError(f"rank {rank}: exit {proc.returncode}"
                                     f"\n{e[-4000:]}")
        return [o for o, _e in texts], seconds


def stats_rays(out: str) -> int:
    """The Total rays of a --stats report."""
    return int(next(line.split(":")[1] for line in out.splitlines()
                    if "Total rays" in line))


def check_mesh(headline_ao):
    """Phase 35: the Renderer's mesh path (parallel/mesh.py) and the CLI
    in two processes joined by torch.distributed (gloo).
    (a) The headline AO frame (640x480, 3x3, 64 rays, tile 240) on
    make_mesh(1), its first frame under sync debug "error"
    (`no_host_sync`): array-equal to phase 4's frame (headline_ao's,
    rendered again), the same rays; kernels 1 and 3 launched, no other
    kernel and no twin; the warm frame seconds of both, best of 2.
    (b) The CLI on the bundled scene as shipped (sunsky AO at its 640x480,
    tile 64: 80 tiles) in one process, then in two processes sharing the
    card: rank 0's .hdr byte-equal to the one process's, the same --stats
    rays, no file from rank 1; the seconds of each run (two ranks on one
    card: not a speed figure).  The kernels are phase 2's build.
    (c) __graft_entry__.dryrun_multichip's four integrators (`dryrun_state`,
    64x32, tile 16) on the mesh of every visible card, each frame equal
    to the same Renderer's without a mesh, with the same rays.
    (d) With two cards or more, the headline frame on the mesh of every
    card, equal to (a)'s; otherwise a line saying it did not run."""
    import torch

    from lucille_tpu_torch.parallel.mesh import make_mesh
    from lucille_tpu_torch.render.renderer import Renderer

    def best_of_2(r):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            r.render_frame()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times), times

    counts = counters()

    def counted(frame):
        for c in counts.values():
            c.reset()
        out = frame()
        return out, {k: c.kernel for k, c in counts.items() if c.kernel}, \
            any(c.plain for c in counts.values())

    # (a)
    headline_ao.stats.nrays = 0
    ref = headline_ao.render_frame()
    ref_rays = headline_ao.stats.nrays
    r = Renderer(bundled_state(640, 480, 3, 64, sunsky=False).scene,
                 tile_size=TILE, mesh=make_mesh(1))
    if r.mesh.devices != (torch.device("cuda", 0),):
        raise AssertionError(f"mesh-1: {r.mesh}")

    def first_frame():
        with no_host_sync(r):
            return r.render_frame()

    got, launches, plain = counted(first_frame)
    if set(launches) != {"closest_hit", "ao_occlusion"} or plain:
        raise AssertionError(f"mesh-1: launches {launches}, twin {plain}")
    if not np.array_equal(got, ref) or r.stats.nrays != ref_rays:
        raise AssertionError(f"mesh-1: frame differs (rays {r.stats.nrays}"
                             f" against {ref_rays})")
    t_mesh, s_mesh = best_of_2(r)
    t_one, s_one = best_of_2(headline_ao)
    print(f"[mesh] (a) headline-ao on make_mesh(1) = {r.mesh}: equal to the "
          f"one-device frame, {ref_rays} rays, launches {launches}; frame "
          f"{t_mesh:.4f} s (samples {[round(t, 4) for t in s_mesh]}), the "
          f"one-device Renderer {t_one:.4f} s (samples "
          f"{[round(t, 4) for t in s_one]})", flush=True)

    # (b)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        one = subprocess.run(
            [sys.executable, "-m", "lucille_tpu_torch.cli", str(BUNDLED_RIB),
             "-o", str(Path(tmp) / "one.hdr"), "--stats"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        t_cli = time.perf_counter() - t0
        if one.returncode != 0:
            raise AssertionError(f"cli: exit {one.returncode}\n"
                                 f"{one.stderr[-4000:]}")
        outs, t_two = cli_ranks(
            [[str(BUNDLED_RIB), "-o", str(Path(tmp) / f"rank{k}.hdr"),
              "--stats"] for k in (0, 1)], 600)
        same = (Path(tmp) / "rank0.hdr").read_bytes() == (
            Path(tmp) / "one.hdr").read_bytes()
        rank1 = (Path(tmp) / "rank1.hdr").exists()
    rays = stats_rays(one.stdout), stats_rays(outs[0])
    print(f"[mesh] (b) the CLI, bundled scene as shipped: one process "
          f"{t_cli:.2f} s, two processes sharing the one card {t_two:.2f} s "
          f"(two ranks on one card: not a speed figure); rank 0's .hdr "
          f"byte-equal to the one process's: {same}; rays {rays}; a file "
          f"from rank 1: {rank1}", flush=True)
    if not same or rays[0] != rays[1] or rank1:
        raise AssertionError("mesh: the two-process render differs")

    # (c)
    mesh = make_mesh()
    for method in DRYRUN_METHODS:
        with tempfile.TemporaryDirectory() as td:
            r0 = Renderer(dryrun_state(method, td).scene, tile_size=16,
                          device="cuda")
            ref_m = r0.render_frame()
            r = Renderer(dryrun_state(method, td).scene, tile_size=16,
                         mesh=mesh)
            got, launches, plain = counted(r.render_frame)
        equal = np.array_equal(got, ref_m)
        print(f"[mesh] (c) dry run [{method}] on {mesh.size} card(s): equal "
              f"to the one-device frame: {equal}, rays {r.stats.nrays} / "
              f"{r0.stats.nrays}, launches {launches}, mean "
              f"{float(got.mean()):.4f}", flush=True)
        if (not equal or r.stats.nrays != r0.stats.nrays or plain
                or not launches or not np.isfinite(got).all()):
            raise AssertionError(f"mesh: dry run [{method}] differs")

    # (d)
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[mesh] (d) mesh over all cards: not run ({n_cards} card "
              "visible)", flush=True)
        return
    r = Renderer(bundled_state(640, 480, 3, 64, sunsky=False).scene,
                 tile_size=TILE, mesh=make_mesh())
    with no_host_sync(r):
        got = r.render_frame()
    if not np.array_equal(got, ref) or r.stats.nrays != ref_rays:
        raise AssertionError("mesh over all cards: the frame differs")
    t_all, s_all = best_of_2(r)
    print(f"[mesh] (d) headline-ao on the mesh of all {n_cards} cards: "
          f"equal to (a)'s; frame {t_all:.4f} s (samples "
          f"{[round(t, 4) for t in s_all]})", flush=True)


@contextmanager
def stdout_to(path):
    """This process's file descriptor 1 (so also its children's standard
    output) written to `path` inside the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def check_fur(results, smi):
    """Phase 36 (a): the fur example (lucille_tpu_torch/examples/fur.py)
    at its defaults on the card: 400 Bezier strands tessellated into
    25,602 triangles, above the dense accel's 16,384, so the tile BVH
    (kernels 4 and 5) at 320x240, 2x2 samples, 64 AO rays, tile 128.
    The example's entry point once; then the frame with phase 4's checks
    and timing (`render_checked`, under no_host_sync); kernels 4 and 5
    against their twins on the scene's first tile (`check_bvh_kernels`,
    phase 7's tolerances; its entries go under those kernels' names in
    the results line); the frame at 80x60 (1x1 samples, 4 AO rays: the
    CPU's twins test every ray against all 37,632 slots) on the card
    against the CPU's twins (`check_frame_twins`, phase 12's bound)."""
    from lucille_tpu_torch.examples import fur
    from lucille_tpu_torch.imageio.rgbe import read_hdr

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/fur.hdr"
        if fur.main(["--out", out]) != 0:
            raise AssertionError("fur: the example failed")
        img = read_hdr(out)
    if img.shape != (240, 320, 3) or not np.isfinite(img).all():
        raise AssertionError(f"fur: the example wrote {img.shape}")
    r = build_renderer("fur", fur.fur_state, 128)
    if r.scene.accel != "pbvh" or r.scene.n_tris != 25602:
        raise AssertionError(f"fur: {r.scene.n_tris} triangles, accel "
                             f"{r.scene.accel}")
    bvh = ("bvh_closest_hit", "bvh_any_hit")
    got, best, _ = render_checked("fur", r, "chip_smoke_fur.hdr", bvh)
    print(f"[fur] 400 strands, 25,602 triangles, 320x240: frame {best:.4f} "
          f"s, {r.stats.nrays / best / 1e6:.1f} Mrays/s on {smi}",
          flush=True)
    check_bvh_kernels("fur", r, 16384, 32768, results)
    for k in bvh:
        results[k][-1]["frame_launches"] = got[k]
    t0 = time.perf_counter()
    check_frame_twins("fur-twins", fur_twins_state)
    print(f"[fur-twins] {time.perf_counter() - t0:.2f} s, the CPU's frame "
          "included", flush=True)


def fur_twins_state():
    """The fur example's scene (400 strands, the tile BVH) at 80x60, 1x1
    samples, 4 AO rays: its frame for the CPU's twins."""
    from lucille_tpu_torch.examples.fur import fur_state

    s = fur_state(400, (80, 60))
    s.PixelSamples(1, 1)
    s.options.gather_nsamples = 4
    return s


def check_viewer(smi):
    """Phase 36 (b): the bundled scene as shipped at 640x480 through the
    CLI (in this process) with --display socket and nothing listening on
    LUCILLE_SOCKET_PORT, LUCILLE_NO_SPAWN_VIEWER unset: the socket display
    spawns the port's viewer, whose argv must name
    lucille_tpu_torch.tools.rockenfield and nothing under tools_tpu, which
    must reassemble every pixel and exit 0 (its terminal previews go to a
    file).  Then the port's viewer started by hand (--out v.hdr --quiet,
    on a free port) for the same command: v.hdr byte-equal to the .hdr
    the command writes with --display file, rows reversed as the file
    driver stores them (phase 25)."""
    from lucille_tpu_torch.cli import main as cli_main
    from lucille_tpu_torch.display import sockdrv
    from lucille_tpu_torch.imageio.rgbe import read_hdr, write_hdr

    argv = [str(BUNDLED_RIB), "--width", "640", "--height", "480"]
    spawned = []
    spawn = sockdrv.SocketDriver._spawn_viewer

    def spy(self):
        ok = spawn(self)
        spawned.append(self._viewer)
        return ok

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sockdrv.SocketDriver._spawn_viewer = spy
        try:
            with environ(LUCILLE_SOCKET_PORT=str(free_port()),
                         LUCILLE_NO_SPAWN_VIEWER=None), \
                    stdout_to(f"{tmp}/viewer.log"):
                rc = cli_main([*argv, "--display", "socket", "-o",
                               f"{tmp}/live"])
        finally:
            sockdrv.SocketDriver._spawn_viewer = spawn
        if rc != 0 or len(spawned) != 1 or spawned[0] is None:
            raise AssertionError(f"viewer: exit {rc}, spawned {spawned}")
        viewer = spawned[0]
        code = viewer.wait(timeout=60)
        args = [str(a) for a in viewer.args]
        with open(f"{tmp}/viewer.log", errors="replace") as f:
            said = [l for l in f.read().splitlines()
                    if l.startswith("[rockenfield]")]
        print(f"[viewer] --display socket at 640x480: spawned {args[1:]}, "
              f"exit {code}; it said {said} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if (args[1:3] != ["-m", "lucille_tpu_torch.tools.rockenfield"]
                or any("tools_tpu" in a for a in args) or code != 0
                or "[rockenfield] frame complete (307200 pixels)" not in said):
            raise AssertionError("viewer: the spawned viewer is not the "
                                 "port's, or it failed")

        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "lucille_tpu_torch.tools.rockenfield",
             "--port", str(port), "--out", f"{tmp}/v.hdr", "--quiet"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            if line != f"[rockenfield] listening on 127.0.0.1:{port}\n":
                raise AssertionError(f"viewer: by hand it said {line!r}")
            with environ(LUCILLE_SOCKET_PORT=str(port),
                         LUCILLE_NO_SPAWN_VIEWER="1"):
                rc = cli_main([*argv, "--display", "socket", "-o",
                               f"{tmp}/live"])
            out, err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0 or proc.returncode != 0:
            raise AssertionError(f"viewer: exit {rc}, the viewer's "
                                 f"{proc.returncode}\n{err[-4000:]}")
        if cli_main([*argv, "--display", "file", "-o", f"{tmp}/f.hdr"]) != 0:
            raise AssertionError("viewer: --display file failed")
        want = read_hdr(f"{tmp}/f.hdr")[::-1]  # the file driver flips rows
        got = read_hdr(f"{tmp}/v.hdr")
        write_hdr(f"{tmp}/raster.hdr", want)  # RGBE decodes and re-encodes exactly
        same = (Path(f"{tmp}/v.hdr").read_bytes()
                == Path(f"{tmp}/raster.hdr").read_bytes())
    print(f"[viewer] by hand on port {port}: v.hdr {got.shape}, mean "
          f"{got.mean():.4f}; byte-equal to --display file's .hdr in raster "
          f"order: {same}; array-equal: {np.array_equal(got, want)} "
          f"(on {smi})", flush=True)
    if not (same and np.array_equal(got, want) and want.mean() > 1.0):
        raise AssertionError("viewer: v.hdr is not the file display's frame")


def check_sisgen_cli(smi):
    """Phase 36 (c): the sisgen command (python -m
    lucille_tpu_torch.tools.sisgen) on env_dir()'s 2048x1024 sky.hdr,
    timed; its .npz equal, exactly, to generate_sis_samples(load_image(
    sky.hdr)), the samples a Renderer generates from the map when its
    structured light names no sisfile; an 80x60 Whitted frame of the
    bundled scene under the structured IBL light with the .npz as its
    sisfile equal to the frame whose Renderer generated the samples.
    env_dir()'s own sky_sis.npz (phases 21-24's) is left as it is."""
    from lucille_tpu_torch.imageio.loader import load_image
    from lucille_tpu_torch.lights.envmap import SIS_SAMPLES
    from lucille_tpu_torch.render.renderer import Renderer

    sky = Path(env_dir().name) / "sky.hdr"
    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "sky_cli.npz"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lucille_tpu_torch.tools.sisgen", str(sky),
             "-o", str(npz), "--text", f"{tmp}/sky_cli.txt"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"sisgen: exit {proc.returncode}\n"
                                 f"{proc.stderr[-4000:]}")
        data = np.load(npz)
        dirs, rgb = data["dirs"], data["rgb"]
        line = 'LightSource "ibl" 1 "texture" ["{}"] "sampling" ["structured"]'
        frames, renderers = {}, {}
        for name, sis in (("sisfile", f' "sisfile" ["{npz}"]'),
                          ("generated", "")):
            s = bundled_state(80, 60, 1, light=line.format(sky) + sis + "\n",
                              method="whitted")
            t1 = time.perf_counter()
            renderers[name] = r = Renderer(s.scene, tile_size=32,
                                           device="cuda")
            t2 = time.perf_counter()
            frames[name] = r.render_frame()
            print(f"[sisgen] the structured frame, samples {name}: Renderer "
                  f"{t2 - t1:.2f} s (the light's samples included), first "
                  f"frame {time.perf_counter() - t2:.2f} s", flush=True)
    env = next(li.env for li in renderers["generated"].lights
               if li.env is not None)
    if not np.array_equal(env.image, load_image(sky)):
        raise AssertionError("sisgen: the Renderer's map is not sky.hdr's")
    gen = env.sis_samples(SIS_SAMPLES)
    equal = all(np.array_equal(a, b) for a, b in zip((dirs, rgb), gen))
    same = np.array_equal(frames["sisfile"], frames["generated"])
    print(f"[sisgen] {sky.name} {SKY[0]}x{SKY[1]} -> {len(dirs)} samples in "
          f"{seconds:.2f} s (the command, interpreter start included) on "
          f"{smi}; .npz equal to generate_sis_samples(load_image(sky.hdr)): "
          f"{equal}; the frame with the .npz as its sisfile equal to the "
          f"generated samples' frame: {same} (mean "
          f"{frames['sisfile'].mean():.4f})", flush=True)
    if not (equal and same and len(dirs) > 0
            and np.isfinite(frames["sisfile"]).all()):
        raise AssertionError("sisgen: the command's samples differ")


def check_obj2rib(smi):
    """Phase 36 (d): the n = 256 terrain (`heightfield_grid`, 130,050
    triangles) written as an OBJ, converted by the port's obj2rib (its
    ground plane and auto-framed camera added: 130,052 triangles, the
    RIB's defaults, 640x480, 2x2 samples, 64 AO rays), and rendered by
    the port's CLI on the card (in this process): the image finite, its
    mean in (0, 1]; kernels 4 and 5 launched, no other kernel, no plain
    twin."""
    from lucille_tpu_torch.cli import main as cli_main
    from lucille_tpu_torch.imageio.rgbe import read_hdr
    from lucille_tpu_torch.tools import obj2rib

    P, quads = heightfield_grid(256)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with open(f"{tmp}/terrain.obj", "w") as f:
            f.write("".join(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in P))
            f.write("".join(f"f {a} {b} {c} {d}\n" for a, b, c, d in quads + 1))
        t1 = time.perf_counter()
        if obj2rib.main([f"{tmp}/terrain.obj", "-o", f"{tmp}/terrain.rib"]):
            raise AssertionError("obj2rib failed")
        t2 = time.perf_counter()
        counts = counters()
        for c in counts.values():
            c.reset()
        rc = cli_main([f"{tmp}/terrain.rib", "-o", f"{tmp}/terrain.hdr",
                       "--stats"])
        t3 = time.perf_counter()
        img = read_hdr(f"{tmp}/terrain.hdr")
    launches = {k: c.kernel for k, c in counts.items()}
    plain = {k: c.plain for k, c in counts.items() if c.plain}
    print(f"[obj2rib] terrain OBJ ({len(quads)} quads) written in "
          f"{t1 - t0:.2f} s, converted in {t2 - t1:.2f} s, rendered by the "
          f"CLI in {t3 - t2:.2f} s (parse, compile, tile-BVH build, frame) on "
          f"{smi}: {img.shape}, mean {img.mean():.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, plain twins "
          f"{plain}", flush=True)
    used = {k for k, v in launches.items() if v}
    if not (rc == 0 and img.shape == (480, 640, 3) and np.isfinite(img).all()
            and 0.0 < img.mean() <= 1.0):
        raise AssertionError(f"obj2rib: exit {rc}, image {img.shape}")
    if used != {"bvh_closest_hit", "bvh_any_hit"} or plain:
        raise AssertionError(f"obj2rib: launches {launches}, twins {plain}")


def check_tools(results, smi):
    """Phase 36: the port's entry points outside the package core on the
    card, each with its wall seconds: (a) the fur example, (b) the
    progressive viewer, (c) the sisgen command, (d) obj2rib."""
    for name, fn, args in (("fur", check_fur, (results, smi)),
                           ("viewer", check_viewer, (smi,)),
                           ("sisgen", check_sisgen_cli, (smi,)),
                           ("obj2rib", check_obj2rib, (smi,))):
        t0 = time.perf_counter()
        fn(*args)
        print(f"[tools/{name}] wall {time.perf_counter() - t0:.2f} s "
              f"({smi})", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lucille_tpu_torch.kernels import build
    from lucille_tpu_torch.render.renderer import Renderer

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

    # 3. the dense kernels against their plain twins at the main paths'
    # shapes (the scenes with their sun, which only the any-hit reads)
    results = {k: [] for k in SOURCES}
    check_kernels("bundled", bundled_state(640, 480, 3, 64).scene, TILE,
                  65536, results)
    check_kernels("heightfield91",
                  heightfield_state(91, sunsky=True).scene, 128, 32768,
                  results)
    # the gather at 2x2 strata on headline-whitted's first bounce (the
    # dome's gather), every hit lane compared
    r = Renderer(bundled_state(640, 480, 3, sunsky=False,
                               method="whitted").scene,
                 tile_size=TILE, device="cuda")
    check_gather("headline-whitted-2x2", r.scene, whitted_gather_inputs(r),
                 2, 2, None, results, names=("ao_occlusion",))
    regs = gather_registers(lib.log)
    for inst, (n_regs, spill) in regs.items():
        print(f"  {inst}: {n_regs} registers, {spill} bytes spilled",
              flush=True)
    for name in ("ao_occlusion", "ao_occlusion_bits"):
        results[name][0]["registers"] = {
            k: v[0] for k, v in regs.items()
            if f", {name.endswith('bits')}, " in k}
    regs = isect_registers(lib.log)
    for inst, (n_regs, spill) in regs.items():
        print(f"  {inst}: {n_regs} registers, {spill} bytes spilled",
              flush=True)
    for name, kern in (("closest_hit", "closest_"), ("any_hit", "any_hit")):
        results[name][0]["registers"] = {
            k: v[0] for k, v in regs.items() if k.startswith(kern)}

    # 4. the headline frames: the bundled scene as shipped (sunsky AO),
    # then plain AO
    launches = {}
    sunsky_path = ("closest_hit", "ao_occlusion_bits", "sky_gather",
                   "any_hit")
    got, _, _ = render_checked(
        "headline-sunsky", Renderer(bundled_state(640, 480, 3, 64).scene,
                                    tile_size=TILE, device="cuda"),
        "chip_smoke_sunsky_640x480.hdr", sunsky_path)
    launches.update(got)
    dense = ("closest_hit", "ao_occlusion")
    headline_ao = Renderer(bundled_state(640, 480, 3, 64,
                                         sunsky=False).scene,
                           tile_size=TILE, device="cuda")
    got, _, _ = render_checked("headline-ao", headline_ao,
                               "chip_smoke_ao_640x480.hdr", dense)
    launches["ao_occlusion"] = got["ao_occlusion"]

    # 37. the sunsky gather's sky against its twin on the headline tile
    check_sky_gather(results, lib.log)

    # 5. the goldens at 80x60
    check_goldens()

    # 6. the dense path's upper range
    render_checked("heightfield91", Renderer(
        heightfield_state(91).scene, tile_size=128, device="cuda"),
        "chip_smoke_heightfield91.hdr", dense)

    # 7. and 8. the tile-BVH kernels, then the large-scene frames
    bvh = ("bvh_closest_hit", "bvh_any_hit")
    cone_imgs = {}
    for n, n_closest, n_any in ((256, 16384, 32768), (724, 4096, 8192)):
        label = f"heightfield{n}"
        r = build_renderer(label, lambda: heightfield_state(n), 128)
        if r.scene.accel != "pbvh":
            raise AssertionError(f"{label}: accel {r.scene.accel}")
        check_bvh_kernels(label, r, n_closest, n_any, results)
        got, _, cone_imgs[n] = render_checked(
            label, r, f"chip_smoke_{label}.hdr", bvh)
        if n == 256:
            launches.update(got)
        for k in bvh:
            results[k][-1]["frame_launches"] = got[k]
    render_checked("heightfield256-sunsky", build_renderer(
        "heightfield256-sunsky", lambda: heightfield_state(256, sunsky=True),
        128), "chip_smoke_heightfield256_sunsky.hdr", bvh)

    # 9. two accels, one scene
    cross_check_accels()

    # 10. kernel 6 against its twin; both closest hits with an active mask
    check_closest_active("bundled", Renderer(
        bundled_state(640, 480, 3, 64, sunsky=False).scene, tile_size=TILE,
        device="cuda"), 65536, results)
    for n, n_slots, n_active in ((256, 256, 16384), (724, 64, 4096)):
        r = build_renderer(f"heightfield{n}", lambda: heightfield_state(n),
                           128)
        check_fused_gather(f"heightfield{n}", r, n_slots, results,
                           ao_gather_inputs(r))
        check_closest_active(f"heightfield{n}", r, n_active, results)
    # kernel 6's other layout (2x2 strata: one warp of 8 slots x 4 strata
    # a block), as the Whitted frame's dome gather runs it
    r = build_renderer("heightfield256-whitted",
                       lambda: heightfield_state(256, method="whitted"), 128)
    check_fused_gather("heightfield256-whitted", r, 4096, results,
                       whitted_gather_inputs(r), 2, 2)

    # 11. the integrator frames
    whitted = ("closest_hit", "ao_occlusion")
    fused = ("bvh_closest_hit", "bvh_ao_fused")
    frames = (
        ("headline-whitted", lambda: bundled_state(
            640, 480, 3, sunsky=False, method="whitted"), TILE, "cone",
         whitted),
        ("headline-pathtrace", lambda: bundled_state(
            640, 480, 3, sunsky=False, method="pathtrace"), TILE, "cone",
         ("closest_hit",)),
        ("bundled-whitted-sunsky", lambda: bundled_state(
            640, 480, 3, method="whitted"), TILE, "cone",
         ("closest_hit", "any_hit")),
        ("heightfield256-whitted", lambda: heightfield_state(
            256, method="whitted"), 128, "cone", bvh),
        ("heightfield256-whitted-fused", lambda: heightfield_state(
            256, method="whitted"), 128, "fused", fused),
        ("heightfield256-ao-fused", lambda: heightfield_state(256), 128,
         "fused", fused),
        ("heightfield724-ao-fused", lambda: heightfield_state(724), 128,
         "fused", fused),
    )
    imgs = {}
    for label, make_state, tile, mode, path in frames:
        with bvh_ao_mode(mode):
            got, _, imgs[label] = render_checked(
                label, build_renderer(label, make_state, tile),
                f"chip_smoke_{label}.hdr", path)
        if label == "heightfield256-ao-fused":
            launches["bvh_ao_fused"] = got["bvh_ao_fused"]
            results["bvh_ao_fused"][0]["frame_launches"] = got["bvh_ao_fused"]

    # 12. Whitted on the card against the plain twins
    check_whitted_twins()

    # 13. the fused gather's frames against the cone gather's
    check_fused_against_cone("heightfield256 AO", cone_imgs[256],
                             imgs["heightfield256-ao-fused"], cone_imgs[256])
    check_fused_against_cone("heightfield724 AO", cone_imgs[724],
                             imgs["heightfield724-ao-fused"], cone_imgs[724])
    check_fused_against_cone("heightfield256 Whitted",
                             imgs["heightfield256-whitted"],
                             imgs["heightfield256-whitted-fused"],
                             cone_imgs[256])

    # 14. the dense scan above 131,072 triangles, and kernels 1 and 2 on
    # its split path
    check_dense_scan(results)

    # 15.-20. this slice's paths: kernel 1 with a finite tmax, the dirt
    # map, depth of field, a textured frame, tile checkpoints, the CLI
    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[{name}] phase wall {time.perf_counter() - t0:.2f} s",
              flush=True)
        return out

    gather_entry = phase("tmax-kernels", check_tmax_kernels, results)
    phase("dirtmap-frames", check_dirtmap_frames, gather_entry)
    phase("dof-frames", check_dof_frames)
    phase("textured-frames", check_textured_frames)
    phase("recover", check_recover)
    phase("cli", check_cli)

    # 21.-25. this slice's paths: the environment samplers' shadow rays
    # through kernels 2 and 5, the environment and pipeline frames, their
    # 80x60 frames against the twins, an imager frame recovered, the
    # socket display
    phase("env-any-hits", check_env_any_hits, results)
    phase("env-frames", check_env_frames, results)
    phase("env-twins", check_env_twins)
    phase("recover-imager", check_recover_imager)
    phase("socket", check_socket_display)

    # 26.-28. this slice's paths: the shader method's frames at full
    # width, its 80x60 frames and the .sl stages against the twins, the
    # CLI with --method shader
    phase("shader-frames", check_shader_frames)
    phase("shader-twins", check_shader_twins)
    phase("shader-cli", check_shader_cli)

    # 29.-33. the grid walk (csrc/ugrid.cu) against its
    # twin, the grid, bruteforce, mxu and re-binned frames at full width
    # and at 80x60 against the twins, inverse rendering, the library paths
    def grid_kernels():
        for label, make_state, tile in (
                ("bundled-grid", lambda: bundled_state(
                    640, 480, 3, 64, sunsky=False, accel="grid"), TILE),
                ("heightfield256-grid", lambda: heightfield_state(
                    256, accel="grid"), 128)):
            check_grid_kernels(label, build_renderer(label, make_state, tile),
                               results, lib.log)

    phase("grid-kernels", grid_kernels)
    launches.update(phase("accel-frames", check_accel_frames, results))
    phase("accel-twins", check_accel_twins)
    phase("inverse-render", check_inverse_render)
    phase("library", check_library_paths)

    # 35. this slice's path: the mesh, and two processes on the card
    phase("mesh", check_mesh, headline_ao)

    # 36. the entry points outside the package core: the fur example on
    # the tile BVH, the progressive viewer, the sisgen command, obj2rib
    phase("tools", check_tools, results, smi)

    # 34. results
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        head = results[name][0]  # the headline / heightfield256 tile
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            **{k: head[k] for k in keys},
            "max_abs_err": max(x["max_abs_err"] for x in results[name]),
            # no PyTorch call intersects rays with triangles or walks a grid
            "library_ms": None,
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
