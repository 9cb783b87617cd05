"""Tile graphs: a tile's device work captured as a CUDA graph, then
replayed.

A tile on the card is ~180 launches (eye rays, the integrator's kernels
and torch glue, the pixel filter, the counters), each a host call.  The
renderer (render/renderer.py) keys each tile.  The first time it sees a
key it renders the tile eagerly, as it would without graphs, and notes
the tile's draws and launch functions (`SeenTile`): a frame rendered
once pays for nothing more.  The second time, every lazy cache is
filled (the kernel library, device.const_vec, the tile BVH's constants,
the sky's parameters); it captures the tile (`capture_tile`), replays
the graph for that frame's pixels, and replays it from then on: one
launch where there were ~180.

- The random draws stay eager.  The first run draws through a
  `NotingStream`, which notes each uniform(path, shape) / randint(path,
  shape, high) request; while the tile is captured its stream is a
  `DrawRecorder`, which hands back a buffer for each of those requests.
  Before each replay `refill` makes the same draws from the tile's real
  stream (the Renderer's sampler at the frame's seed) and copies them
  into those buffers, so a replayed tile sees exactly the numbers an
  eager one draws, from any sampler.
- Whatever a replay reads and the host writes between replays (the
  draws' buffers; the subpixel table and weights, Renderer._consts; the
  scene) is allocated before the capture begins.  Memory that a capture
  allocates belongs to the graph only from that allocation on: the
  caching allocator hands the next allocation on the capturing stream a
  block freed earlier in the same capture, so an earlier node of the
  graph uses that memory for a temporary, and in a replay it overwrites
  what the host put there before the later nodes read it.  (On an H100
  the AO tile's (2, B) draw buffer, allocated at the draw inside the
  capture, took the address of a 49,152-byte temporary that the capture
  had allocated and freed before it; after each replay the buffer held
  that temporary's values, so every replay rendered the same jitter,
  whatever was drawn.)
- A capture's calls of the launch wrappers count nothing: the
  LaunchCounts it moved (`launch_counts`) are put back, and each replay
  adds the same deltas, as it launches the same kernels.  chip_smoke.py's
  counted frames and the gpu tests hold those counts against the kernels
  the profiler's device trace shows.
- The launch functions' guard, for the tests' and the benchmark's
  recorders (benchmark/harness/capture.py), which replace a launch
  function of accel/ with a wrapper to see its launches: `base/timer.
  traced` adds each wrapper called inside `Timer.recording_launches` to a
  set, and before a capture and before each replay the tile checks that
  each one it called is still its module's attribute.  Where one was
  replaced, the tile renders eagerly, so the replacement sees its
  launches.  This is the one use of that hook.
- A capture that raises (a tile that waits on the card, an operation a
  graph cannot hold) is logged once, and its tile renders eagerly from
  then on.  Capture errors are confined to the capturing thread.
"""

from __future__ import annotations

import sys

import torch

from lucille_tpu_torch.base.log import LOG_WARN, log_once
from lucille_tpu_torch.base.timer import get_timer


def launch_counts() -> tuple:
    """Every kernel wrapper's LaunchCounts (each a module global of
    accel/)."""
    from lucille_tpu_torch.accel import ao, bvh_ao, bvh_isect, isect, ugrid

    return (isect.COUNTS, isect.ANY_COUNTS, ao.COUNTS, ao.BITS_COUNTS,
            ao.SKY_COUNTS, bvh_isect.CLOSEST_COUNTS, bvh_isect.ANY_COUNTS,
            bvh_ao.FUSED_COUNTS, ugrid.COUNTS, ugrid.ANY_COUNTS)


def _still_theirs(launches) -> bool:
    """True while each launch function is still the attribute of its
    module it was defined as."""
    return all(getattr(sys.modules.get(fn.__module__), fn.__name__, None)
               is fn for fn in launches)


class NotingStream:
    """A tile's stream passed through, its draws noted: (path, shape,
    high or None for uniform, dtype) in the order the tile makes them.
    A tile's first run draws through it, so the recorder knows what to
    allocate."""

    def __init__(self, stream):
        self.stream = stream
        self.draws = []

    def uniform(self, path, shape) -> torch.Tensor:
        u = self.stream.uniform(path, shape)
        self.draws.append((tuple(path), tuple(shape), None, u.dtype))
        return u

    def randint(self, path, shape, high: int) -> torch.Tensor:
        i = self.stream.randint(path, shape, high)
        self.draws.append((tuple(path), tuple(shape), int(high), i.dtype))
        return i


class SeenTile:
    """A tile rendered once: the draws its run noted (NotingStream) and
    the launch functions it called, for its capture the next time."""

    def __init__(self, draws, launches):
        self.draws = draws
        self.launches = tuple(launches)

    def capturable(self) -> bool:
        return _still_theirs(self.launches)


class DrawRecorder:
    """The stream a tile sees while it is captured.  It holds a buffer on
    `device` for each draw of the tile's first run (`noted`, from a
    NotingStream), allocated before the capture begins (module
    docstring).  Each draw hands back the next buffer, and raises where
    the tile asks for another draw than its first run made; `refill`
    draws them again before a replay."""

    def __init__(self, noted, device):
        self.draws = [(path, shape, high,
                       torch.empty(shape, dtype=dtype, device=device))
                      for path, shape, high, dtype in noted]
        self._next = 0

    def _take(self, path, shape, high) -> torch.Tensor:
        if self._next >= len(self.draws):
            raise ValueError("the tile draws more than its first run did")
        want, self._next = self.draws[self._next], self._next + 1
        if want[:3] != (tuple(path), tuple(shape), high):
            raise ValueError(f"the tile draws {tuple(path)} {tuple(shape)} "
                             f"where its first run drew {want[0]} {want[1]}")
        return want[3]

    def uniform(self, path, shape) -> torch.Tensor:
        return self._take(path, shape, None)

    def randint(self, path, shape, high: int) -> torch.Tensor:
        return self._take(path, shape, int(high))

    def refill(self, stream) -> None:
        """The noted draws made again from `stream` (the tile's stream
        for this frame) into their buffers."""
        for path, shape, high, buf in self.draws:
            buf.copy_(stream.uniform(path, shape) if high is None
                      else stream.randint(path, shape, high))


class TileGraph:
    """One tile's captured work: the graph, its draws' buffers, its
    outputs (image, counters: static tensors that every replay
    rewrites), the launch functions it called and the LaunchCounts
    deltas of one run."""

    def __init__(self, graph, recorder: DrawRecorder, outputs, launches,
                 deltas):
        self.graph = graph
        self.recorder = recorder
        self.outputs = outputs
        self.launches = tuple(launches)
        self.deltas = tuple(deltas)

    def replayable(self) -> bool:
        return _still_theirs(self.launches)

    def replay(self):
        """Launch the graph on the current stream (the caller refills its
        draws first) and count its launches; returns its outputs."""
        self.graph.replay()
        for counts, kernel, plain in self.deltas:
            counts.kernel += kernel
            counts.plain += plain
        return self.outputs


def capture_tile(run, seen: SeenTile, device, pool):
    """run(stream) -> (image, counters) on `device`, captured with a
    DrawRecorder of the draws `seen` noted as its stream, into a CUDA
    graph whose memory comes from `pool` (torch.cuda.graph_pool_handle(),
    one a replica).  Nothing is recorded in the frame and no launch is
    counted.  Returns a TileGraph, or None where the capture raised
    (logged once)."""
    counts = launch_counts()
    before = [(c.kernel, c.plain) for c in counts]
    try:
        recorder = DrawRecorder(seen.draws, device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        timer = get_timer()
        with (timer.paused(), timer.recording_launches() as launches,
              torch.cuda.stream(side)):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = run(recorder)
            finally:
                graph.capture_end()
        current.wait_stream(side)
    except Exception as e:  # noqa: BLE001 - any failure leaves the tile eager
        log_once(LOG_WARN, "a tile could not be captured as a CUDA graph "
                 "(%s: %s); such tiles render eagerly", type(e).__name__, e)
        return None
    finally:
        deltas = []
        for c, (kernel, plain) in zip(counts, before):
            if (c.kernel, c.plain) != (kernel, plain):
                deltas.append((c, c.kernel - kernel, c.plain - plain))
            c.kernel, c.plain = kernel, plain
    return TileGraph(graph, recorder, outputs, launches, deltas)


def camera_key(camera) -> tuple:
    """What the eye rays read of the camera (ri/camera.generate_rays), as
    a hashable: a change of view, resolution or lens gives a new key."""
    consts = b"".join(c.tobytes() for c in camera.ray_constants())
    return (consts, camera.camera_projection,
            camera.horizontal_resolution, camera.vertical_resolution,
            camera.dof_active, camera.fstop, camera.focal_length,
            camera.focal_distance, camera.flength)
