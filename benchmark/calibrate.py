#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> [--seeds N] [--control M]
                                   [--stale K] [--first SEED]

- sound: for each of N seeds, the cell's frames 1 .. frames + 1 rendered
  by the timed path (Renderer.render_frame at the cell's size, the seed
  set as the window sets it) and compared with the plain reference on the
  pixels a run draws: px_off, as a run prints it;
- control: for each of M seeds, the reference itself computed in
  bfloat16 (the precision below the configuration's float32) put in the
  program's place on the same frames and pixels: its px_off against the
  float32 reference;
- stale: for the first K of the N seeds, the fault of a renderer that
  returns its state unchanged: each frame k judged by the image of frame
  k - 1 (the warm frame for the first), rendered by the timed path.

Prints one JSON line a seed and a summary line (the largest sound
reading, the smallest control and stale readings).  Needs a CUDA card unless
--device cpu is given (tests run it so at a small size).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import manifest as mf  # noqa: E402
from harness.check import (  # noqa: E402
    compare, draw_pixels, frame_seed, pixels_off)
from harness.scenes import program_scene, reference_scene  # noqa: E402


def readings(workload: str, seeds, control_seeds, root=mf.ROOT,
             device="cuda", out=print, stale=0) -> dict:
    import torch

    from reference import render_pixels

    manifest = mf.load(root)
    cell = mf.workload(manifest, workload)
    config = mf.config(manifest, cell["config"], root)
    traffic = mf.traffic(cell["traffic"], root / "benchmark")
    check = traffic["check"]
    from lucille_tpu_torch.render.renderer import Renderer

    r = Renderer(program_scene(config, traffic).scene,
                 tile_size=traffic["tile"], device=device, seed=0)
    r.render_frame()
    scene, frame = reference_scene(config, traffic)
    ks = range(1, check["frames"] + 2)
    sound, stale_off = [], []
    for i, seed in enumerate(seeds):
        frames = []
        for k in ks:
            r.sampler.seed = frame_seed(seed, k)
            frames.append((k, r.render_frame()))
        got = compare(frames, seed, scene, frame, check, device)
        sound.append(got["px_off"])
        out(json.dumps({"kind": "sound", "seed": seed, **got}))
        if i < stale:
            r.sampler.seed = frame_seed(seed, 0)
            images = [r.render_frame()] + [img for _k, img in frames]
            got = compare([(k, images[j]) for j, k in enumerate(ks)], seed,
                          scene, frame, check, device)
            stale_off.append(got["px_off"])
            out(json.dumps({"kind": "stale", "seed": seed, **got}))
    control = []
    cache = {}
    for seed in control_seeds:
        off = total = 0
        for k in ks:
            pix = draw_pixels(seed, k, frame.width, frame.height,
                              check["pixels"])
            ref = render_pixels(scene, frame, frame_seed(seed, k), pix,
                                device, torch.float32, cache)
            low = render_pixels(scene, frame, frame_seed(seed, k), pix,
                                device, torch.bfloat16, cache)
            off += pixels_off(low, ref, check)
            total += len(pix)
        control.append(off / total)
        out(json.dumps({"kind": "control", "seed": seed,
                        "px_off": off / total, "pixels": total}))
    summary = {"kind": "summary", "workload": workload,
               "sound_max": max(sound, default=None),
               "control_min": min(control, default=None),
               "stale_min": min(stale_off, default=None),
               "limit": check["limits"]["px_off"]}
    out(json.dumps(summary))
    return summary


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--stale", type=int, default=3)
    p.add_argument("--first", type=int, default=2_200_000_001)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    seeds = [a.first + 7919 * i for i in range(a.seeds)]
    control = [a.first + 104729 + 7919 * i for i in range(a.control)]
    readings(a.workload, seeds, control, device=a.device,
             stale=min(a.stale, a.seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
