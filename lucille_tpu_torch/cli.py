"""Command-line renderer for the port: the `lsh` flags of lucille_tpu's CLI.

    python -m lucille_tpu_torch.cli [options] [scene.rib] [--device cuda]

    --output FILE      override the display name
    --display D        override the display driver: file (hdr), openexr
                       (exr), socket (streams tiles to a viewer on
                       localhost, LUCILLE_SOCKET_PORT, default 12346;
                       spawns the port's viewer, python -m
                       lucille_tpu_torch.tools.rockenfield, unless
                       LUCILLE_NO_SPAWN_VIEWER=1), framebuffer (the
                       socket viewer, else a file), null
    --pixelsamples N   override PixelSamples
    --maxraydepth N    override the maximum ray depth
    --gather-rays N    AO / dirt-map gather rays (ntheta = nphi =
                       int(sqrt(N)))
    --method M         ao (default), whitted, pathtrace, dirtmap, shader
                       (each geometry's surface shader: a built-in, or
                       <name>.sl on the shader search path)
    --nthreads N       accepted for lsh compatibility, ignored
    --tile N           tile size, default 64
    --order O          spiral|scanline|zorder|hilbert
    --accel A          auto|pallas|bvh|grid|bruteforce|mxu: auto picks
                       the dense tiles up to 16384 triangles and the tile
                       BVH above; pallas asks for the dense tiles, bvh for
                       the tile BVH, grid for lucille_tpu's uniform grid
                       (a DDA walk, csrc/ugrid.cu); bruteforce and mxu,
                       lucille_tpu's dense intersectors, render on the
                       dense tiles in input order, their gathers scanned
                       stratum by stratum as lucille_tpu scans them
    --mesh N           shard tiles over an N-device mesh (default: every
                       process's card in a multi-process run, one
                       device otherwise); with --device cpu, N CPU
                       replicas
    --coordinator H:P  process 0's address (torch.distributed, gloo)
    --num-processes N  the processes of a multi-process render
    --process-id I     this process's index
    --recover          tile checkpoints: <display name>.ckpt.npz is
                       written after each tile and resumed from
    --width/--height   override the image size
    --debug --stats --verbose   debug logging, ray statistics, progress
    --profile FILE     render under torch.profiler (CPU, and CUDA on a
                       card) and write its Chrome trace to FILE: the
                       renderer's spans (frame, frame.enqueue, tile,
                       tile.rays, tile.integrate, accel.*, tile.filter,
                       tile.pull, tile.deliver; base/timer.py) beside
                       the torch ops and kernels; with --stats also
                       each span's self time a frame (process 0 only)
    --device D         cuda (default) or cpu

With no RIB the CLI enters the interactive shell (shell.py) on --device.
A scene with an AreaLightSource "sunsky" renders the reference's sunsky
AO (sky radiance over the open strata plus the sun), on either accel; a
scene without lights gets the reference's constant dome, which Whitted
gathers through the AO kernels.  LUCILLE_BVH_AO=fused selects the fused
tile-BVH AO gather, =rebinned the re-binned one, as they do for
lucille_tpu.  A dome or IBL light
with an environment texture renders through its "sampling" token
(cosweight, importance, stratified, structured, bruteforce); the
displacement, atmosphere and imager shaders, built in or .sl sources on
the search path, run as lucille_tpu runs them (shading/pipeline.py), and
an imager's frame is written to the displays again after the post-pass.
A multi-process render runs this CLI once per process with the same
--coordinator and --num-processes and each its --process-id: the
processes join before anything touches a device, each renders its
mesh slots' tiles on its card (process index modulo the cards visible,
so two processes on one card share it), every process assembles the
frame, and process 0 alone opens the displays, reads and writes the
checkpoint and prints --stats (parallel/, lucille_tpu/cli.py:98-262).
CLI overrides are applied at WorldBegin through the backdoor callback,
as lucille_tpu's CLI does (lucille_tpu/cli.py:139-166).
"""

from __future__ import annotations

import argparse
import sys
from contextlib import nullcontext

def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lucille-tpu-torch",
        description="RenderMan-style renderer on PyTorch/CUDA",
    )
    p.add_argument("rib", nargs="?", default=None,
                   help="RIB scene file; omit for the interactive shell")
    p.add_argument("--output", "-o", help="override output file name")
    p.add_argument("--display",
                   help="override the display driver (file|openexr|"
                        "socket|framebuffer|null)")
    p.add_argument("--pixelsamples", type=int, help="subpixel samples per axis")
    p.add_argument("--maxraydepth", type=int, help="maximum ray depth")
    p.add_argument("--gather-rays", type=int, help="AO gather rays")
    p.add_argument("--tile", type=int, default=64, help="tile size (default 64)")
    p.add_argument("--order", choices=["spiral", "scanline", "zorder", "hilbert"],
                   help="tile order (default spiral)")
    p.add_argument("--accel",
                   choices=["auto", "bvh", "grid", "bruteforce", "mxu", "pallas"],
                   help="accel override: auto (by triangle count), pallas "
                        "(dense tiles), bvh (tile BVH), grid (uniform grid), "
                        "bruteforce and mxu (dense tiles, input order)")
    p.add_argument("--method",
                   choices=["ao", "whitted", "pathtrace", "dirtmap", "shader"],
                   help="integrator override (Option \"renderer\" \"method\")")
    p.add_argument("--nthreads", type=int, help="accepted for lsh compatibility")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard tiles over an N-device mesh (default: all "
                        "devices in a multi-process run, single device "
                        "otherwise)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process coordinator address "
                        "(torch.distributed; the ri_parallel_init analog, "
                        "parallel.c:62)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index")
    p.add_argument("--recover", action="store_true",
                   help="tile-level checkpoint and resume")
    p.add_argument("--width", type=int, help="override image width")
    p.add_argument("--height", type=int, help="override image height")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--stats", action="store_true", help="print ray statistics")
    p.add_argument("--profile", metavar="FILE",
                   help="write a torch.profiler Chrome trace of the frame, "
                        "with the renderer's spans, to FILE")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def main(argv=None) -> int:
    p = build_argparser()
    args = p.parse_args(argv)
    from lucille_tpu_torch.parallel.distributed import (
        finalize_distributed,
        initialize_distributed,
    )

    # bring-up first, before anything touches a device: the reference
    # calls ri_parallel_init before RiBegin (main.c:119)
    try:
        distributed = initialize_distributed(
            args.coordinator, args.num_processes, args.process_id)
    except ValueError as e:
        p.error(str(e))
    try:
        return _run(p, args, distributed)
    finally:
        finalize_distributed()


def _run(p, args, distributed: bool) -> int:
    from lucille_tpu_torch.base.log import set_debug
    from lucille_tpu_torch.base.timer import get_timer
    from lucille_tpu_torch.display.drivers import get_display_driver
    from lucille_tpu_torch.parallel.distributed import (
        barrier,
        is_primary_host,
        process_count,
    )
    from lucille_tpu_torch.parallel.mesh import make_mesh
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib_file
    from lucille_tpu_torch.render.renderer import Renderer

    if args.debug:
        set_debug(True)
    if args.rib is None:  # no scene: the interactive shell (lsh.c)
        from lucille_tpu_torch.shell import Shell

        Shell(device=args.device).run()
        return 0

    def apply_overrides(state: RiState):
        """Backdoor world_begin callback (lsh main.c:213-241)."""
        opt = state.options
        if args.pixelsamples is not None:
            state.PixelSamples(args.pixelsamples, args.pixelsamples)
        if args.maxraydepth is not None:
            opt.max_ray_depth = args.maxraydepth
        if args.gather_rays is not None:
            opt.gather_nsamples = args.gather_rays
        if args.accel is not None:
            opt.accel_method = args.accel
        if args.method is not None:
            opt.render_method = args.method
        if args.order is not None:
            opt.bucket_order = args.order
        if args.width is not None or args.height is not None:
            state.Format(args.width or opt.width, args.height or opt.height)
        if args.output is not None:
            disp = opt.current_display()
            disp.name = args.output
            if disp.driver == "framebuffer":
                disp.driver = "file"
        if args.display is not None:
            opt.current_display().driver = args.display
        opt.tile_size = args.tile

    timer = get_timer()
    state = RiState()
    state.world_begin_cb = apply_overrides
    timer.start("RIB parsing")
    try:
        parse_rib_file(args.rib, state)
    except FileNotFoundError:
        print(f"lucille-tpu-torch: cannot open '{args.rib}'", file=sys.stderr)
        return 1
    timer.end("RIB parsing")
    if state.world_block == 0:
        return 0  # no WorldBegin/WorldEnd: nothing to render

    desc = state.scene
    opt = desc.options
    mesh = None
    if args.mesh is not None or distributed:
        # None: every process's devices; on the CPU, the replicas asked
        # for, shared out over the processes
        devices = (None if args.device != "cpu" else
                   ["cpu"] * -(-(args.mesh or process_count())
                               // process_count()))
        try:
            mesh = make_mesh(args.mesh, devices=devices)
        except (ValueError, RuntimeError) as e:
            p.error(f"--mesh: {e}")
    renderer = Renderer(desc, tile_size=opt.tile_size, device=args.device,
                        mesh=mesh)

    # host 0 owns every display, as lucille's rank 0 alone opens, writes
    # and closes them (render.c:468-514, 1219-1243)
    drivers = []
    for d in (opt.displays or [None]) if is_primary_host() else ():
        if d is None:
            drv = get_display_driver("framebuffer")
            drv.open("untitled.hdr", opt.width, opt.height)
        else:
            drv = get_display_driver(d.driver)
            drv.open(d.name, opt.width, opt.height)
        drivers.append(drv)

    def tile_cb(x0, y0, tile):
        for drv in drivers:
            drv.write(x0, y0, tile)

    def progress_cb(frac):
        for drv in drivers:
            drv.progress(frac)
        if args.verbose:
            print(f"\r{frac * 100:3.0f}%", end="", flush=True)

    ckpt = None
    if args.recover:  # lucille_tpu/cli.py:236-242; host 0's, broadcast
        base = ((opt.current_display().name or "untitled.hdr")
                if opt.displays else "untitled.hdr")
        ckpt = base + ".ckpt.npz"
    profiling = nullcontext()
    if args.profile and is_primary_host():
        from torch.profiler import ProfilerActivity, profile

        profiling = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if renderer.device.type == "cuda"
            else []))
    with profiling as prof:
        image = renderer.render_frame(tile_cb=tile_cb,
                                      progress_cb=progress_cb,
                                      checkpoint=ckpt, recover=args.recover)
    if prof is not None:
        prof.export_chrome_trace(args.profile)
    if opt.imager:
        # the imager ran over the assembled frame: write it again so the
        # file and socket drivers flush the post-processed pixels
        tile_cb(0, 0, image)
    if args.verbose:
        print()
    for drv in drivers:
        drv.close()
    barrier("frame-end")  # render.c:368's post-frame MPI barrier
    if (args.stats or args.verbose) and is_primary_host():
        print(renderer.stats.report())
        print(timer.dump())
        if args.profile:
            print(timer.span_report(timer.recorded_frames(1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
