"""One run of one cell: set-up, the measured window, the traced frames,
the check against the plain reference, the result line.

    set-up   process start -> the port's RIB front end builds the scene ->
             Renderer(...) (the scene compile, the tile BVH) -> two warm
             frames, both with frame 0's seed: the first loads or builds
             the kernel library and runs every shape the cell uses, the
             second captures each tile's CUDA graph (the port captures a
             tile the second time it sees it), so every window frame
             replays -> setup_s
    window   Renderer.render_frame(tile_cb=...) back to back for
             --seconds; frame k draws its random numbers with
             frame_seed(seed, k) (the port's default tile sampler, its
             seed set before the frame); every frame ends with every tile
             pulled to the host and assembled; the display write is not
             in the window
    traced   with --trace 1, the window's first `traced_frames` frames run
             under torch.profiler, then (after the window) the first
             traced frame once more with recorders on the kernels'
             launch functions, for the rooflines
    check    after the window, the peak memory read and the program's
             state freed: sampled pixels of sampled frames against the
             reference (harness/check.py)

End-to-end metrics (host clock, never from the program):
frame_s = window seconds / frames completed; frame_p95_s = the 95th
percentile of every completed frame's seconds; first_tile_p95_s = the
95th percentile over the frames of the seconds from the call to the
first tile_cb; setup_s as above, its parts printed beside the result
(`setup_phases`): imports (torch and the port), cuda_context, scene (the
RIB front end), renderer (the scene compile), warm_frame (both warm
frames).

The guard against JAX runs twice: as the window closes, and again after
the check, just before the result is printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from harness import manifest as mf
from harness.check import FrameSample, compare, frame_seed
from harness.guard import banned_loaded
from harness.scenes import program_scene, reference_scene

# frames rendered before the window: the port runs a tile eagerly the
# first time it sees it and captures its graph the second
WARM_FRAMES = 2


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root) -> None:
    """Every build and kernel cache a library of the run could write, at
    fixed paths inside the checkout (the port builds its kernels into
    its own lucille_tpu_torch/_build/, which is inside it too)."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def run_cell(args, t_start: float, root=mf.ROOT, device="cuda") -> dict:
    """The cell's run; returns the result line's fields and the checks."""
    import torch

    from lucille_tpu_torch.base.timer import get_timer
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.sampling.jitter import TileSampler

    manifest = mf.load(root)
    cell = mf.workload(manifest, args.workload)
    config = mf.config(manifest, cell["config"], root)
    traffic = mf.traffic(cell["traffic"], root / "benchmark")
    e2e, per_layer = mf.cell_metrics(manifest, cell["name"])
    check = traffic["check"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- set-up ---------------------------------------------------------
    phases, t_mark = {}, [t_start]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - t_mark[0]
        t_mark[0] = now

    phase("imports")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
        sync()
    phase("cuda_context")
    state = program_scene(config, traffic)
    phase("scene")
    timer = get_timer()
    c0 = timer.elapsed("Scene compile")
    r = Renderer(state.scene, tile_size=traffic["tile"], device=device,
                 seed=frame_seed(args.seed, 0))
    compile_s = timer.elapsed("Scene compile") - c0
    if not isinstance(r.sampler, TileSampler):
        raise TypeError("the renderer's default sampler is not the tile "
                        "sampler whose seed the benchmark sets")
    phase("renderer")
    for _ in range(WARM_FRAMES):
        r.sampler.seed = frame_seed(args.seed, 0)
        r.render_frame()
    sync()
    phase("warm_frame")
    setup_s = time.perf_counter() - t_start

    # -- window ---------------------------------------------------------
    frames = FrameSample(args.seed, check["frames"])
    durations, firsts = [], []
    attempted = failed = 0
    k = 1
    trace, traced_k = None, None

    def one_frame(k):
        r.sampler.seed = frame_seed(args.seed, k)
        first = []
        t0 = time.perf_counter()
        img = r.render_frame(
            tile_cb=lambda *_a: first or first.append(time.perf_counter()))
        return img, time.perf_counter() - t0, first[0] - t0

    t_w0 = time.perf_counter()
    deadline = t_w0 + args.seconds
    if args.trace:
        from harness.trace import hand_kernel_names, profile_frames
        import lucille_tpu_torch

        n_traced = traffic.get("traced_frames", 3)
        traced_k = k
        traced = []

        def traced_frame():
            traced.append(one_frame(traced_k + len(traced)))

        trace = profile_frames(
            traced_frame, n_traced, hand_kernel_names(
                Path(lucille_tpu_torch.__file__).parent))
        for img, _d, _f in traced:
            attempted += 1
            if np.isfinite(img.sum()):
                frames.offer(k, img)
            else:
                failed += 1
            k += 1
    while time.perf_counter() < deadline:
        attempted += 1
        try:
            img, dt, first = one_frame(k)
        except Exception as e:  # a frame that raises fails; the window goes on
            failed += 1
            print(f"frame {k} raised {type(e).__name__}: {e}",
                  file=sys.stderr)
            k += 1
            continue
        if np.isfinite(img.sum()):
            durations.append(dt)
            firsts.append(first)
            frames.offer(k, img)
        else:
            failed += 1
        k += 1
    window_s = time.perf_counter() - t_w0
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    found = banned_loaded()
    if found:
        raise RuntimeError(f"loaded after the window: {', '.join(found)}")

    values = {}
    if durations:
        values = {"frame_s": window_s / len(durations),
                  "frame_p95_s": p95(durations),
                  "first_tile_p95_s": p95(firsts), "setup_s": setup_s}

    # -- per-layer metrics, on the program's state ------------------------
    layer_values = {}
    if args.trace:
        from harness.capture import recording
        from harness.trace import kernel_pattern

        captures = {}
        with recording(captures):
            r.sampler.seed = frame_seed(args.seed, traced_k)
            r.render_frame()
        sync()

        def kernel_seconds(name):
            pat = kernel_pattern([name])
            return sum(s for n, (s, _c) in trace["by_name"].items()
                       if pat.search(n)) / trace["frames"]

        ctx = SimpleNamespace(trace=trace, compile_s=compile_s,
                              captures=captures,
                              kernel_seconds=kernel_seconds, cell=cell,
                              config=config, traffic=traffic)
        for m in per_layer:
            v = mf.metric_reader(m["name"], root / "benchmark" / "metrics")(
                ctx)
            if v is not None:
                layer_values[m["name"]] = {"value": float(v),
                                           "unit": m["unit"]}
        del captures, ctx

    # -- the check, on the program's frames alone -------------------------
    kept = frames.frames()
    del r, state, frames
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    scene, frame = reference_scene(config, traffic)
    got = compare(kept, args.seed, scene, frame, check, device)
    checks = {
        "px_off": {"value": got["px_off"], "limit": check["limits"]["px_off"]},
        "failed_frames": {"value": failed, "limit": 0},
    }
    correct = (bool(kept) and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if args.trace:
        result["metrics"] = layer_values
    else:
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in e2e if m["name"] in values}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if args.trace:
        dev.update(busy_s=trace["busy_s"], window_s=trace["wall_s"])
    result["device"] = dev
    if args.trace:
        result["breakdown"] = trace["breakdown"]
    result["sampled_pixels"] = got["pixels"]
    result["setup_phases"] = phases
    result["checks"] = checks
    return result


def main(argv, t_start: float, root=mf.ROOT) -> int:
    args = parse(argv)
    manifest = mf.load(root)
    cell = mf.workload(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload}: needs {cell['chips']} CUDA card(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache_env(root)
    result = run_cell(args, t_start, root)
    found = banned_loaded()
    if found:
        print(f"loaded after the check, no result: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    print(smi_line(), flush=True)
    print(json.dumps(result), flush=True)
    for name, s in result["setup_phases"].items():
        print(f"setup {name} {s!r} s", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0
