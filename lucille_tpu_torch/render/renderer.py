"""Frame renderer: the tile loop on one torch device or over a mesh.

Counterpart of lucille_tpu/render/renderer.py:41-152 and :269-591:

- the image is cut into full-size tiles (edge tiles are rendered past the
  image edge and cropped on the host), so every tile traces
  B = tile_w * tile_h * S eye rays;
- per tile: Hammersley subpixel positions -> eye rays (through the
  thin lens when the camera has depth of field, the lens samples drawn
  from the tile's stream at the path (0x10EF,), lucille_tpu's
  fold_in(key, 0x10EF)) -> the render method's integrator
  (transport/dispatch.py: AO, Whitted, path tracing, the dirt map or
  the surface shaders) with Option "trace" "max_ray_depth", the option's
  bgcolor and the texture atlas -> per-subsample pixel-filter weights;
- under the shader method the shader table (each geometry's surface
  shader, built-in or compiled from its .sl, its parameters bound on
  the device) is built once per Renderer and handed to every tile
  (lucille_tpu/render/renderer.py:226-230, :66-69);
- every tile is enqueued on the device before the first is pulled back,
  then tiles reach the display callbacks in tile-list (spiral) order;
  each tile's image and counters are copied to pinned host memory right
  behind its own work, so its pull waits for that tile alone
  (parallel/mesh.py);
- a tile graph (render/graphs.py): on a card, a tile of an integrator
  that declares itself capturable (its `graph_key`; the AO integrator
  does, Whitted, the path tracer, the dirt map and the shaders do not)
  renders eagerly the first time it is seen, as without graphs; the
  second time it is captured as one CUDA graph (its eye rays, the
  integrator, the pixel filter and the counters) and replayed, and from
  then on replayed, its random draws made eagerly into the graph's
  buffers first.  A frame rendered once (the CLI, a view that changes
  every frame) runs no graph.  One graph a tile key (the replica, the
  tile's rectangle, the render method, the options the integrator
  reads, the camera, the subpixel table and the integrator's own
  switches); a replica's graphs share one memory pool, and it keeps the
  graphs of one frame key (one view) at a time.  A tile renders
  eagerly where it is on the CPU, where its integrator is not
  capturable, where its capture failed, and where a launch function it
  called has been replaced since;
- each tile's random numbers come from its own stream, drawn per tile
  origin (sampling/jitter.py), so cropped pixels equal the full render's;
- counters per tile: nrays (as lucille_tpu counts them), ntests, ntrav
  (0 where the integrator reports none, as lucille_tpu's Whitted and path
  tracer do);
- the light tables are built once (lucille_tpu/render/renderer.py:
  209-211), an area light's device tables with them, and handed to the
  integrator: a sunsky light turns the AO gather into the sunsky gather;
  a scene without lights gets the reference's constant dome;
- the material textures are loaded once through the option's search
  paths into one atlas on the render device (`_texture_images`,
  lucille_tpu/render/renderer.py:594-630); a missing or unreadable file
  is logged and ignored;
- the shading pipeline (shading/pipeline.py) in lucille_tpu's order:
  the displacement shaders move the vertices before the compile
  (lucille_tpu/render/renderer.py:199-201); the frame's atmosphere, the
  first geometry's that binds one (:218-236), fogs each tile's radiance
  before the pixel filter by the eye rays' lengths, where the integrator
  reports their t (:106-121), its constants built once per Renderer;
  with an imager each tile also returns its alpha, the fraction of its
  subsamples that hit (:145-149), and the imager runs over the assembled
  frame after the last pull (:566-577); a stage whose shader is not
  built in runs its .sl from the search path, compiled once per
  Renderer (`self.shaders`, which holds its .sl surfaces too);
- with a `checkpoint` path, the frame's image, alpha and tile-done
  bitmap are written atomically after each pulled tile, in lucille_tpu's
  file layout (npz keys image, done, meta = [W, H, tile_w, tile_h,
  xsamples, ysamples, ntiles] and alpha), and removed when the frame
  completes; `recover` resumes from a matching file, enqueuing only the
  tiles it lacks and replaying the others to the callbacks
  (lucille_tpu/render/renderer.py:548-608, 724-768).  The saves are host
  work after a tile's pull;
- with a mesh (parallel/mesh.py; lucille_tpu/render/renderer.py:193,
  259-266, 354-440) the displacement runs once (it edits the scene
  description) and the scene compiles once on the host, the tile BVH
  with it; each device this process owns in the mesh gets a replica:
  the scene's tensors, the atlas, the lights, the atmosphere, the
  shader table (each .sl compiled once, in `self.shaders`) and its own
  sampler, so a tile's random numbers depend on (seed, x0, y0, path)
  alone, whichever device draws them; a card's replica renders the
  first tile once when it is built, so its per-device constants are
  copied then.  The tiles not done go in rounds of the mesh's size,
  tile-list order, slot d of a round on device d; every owned tile of
  every round is enqueued before the first pull, then one pull a round
  (one all_gather_host where the mesh spans processes) gives every
  process the whole frame.  A short last round leaves its slots past
  the end empty, so the counters equal the one-device frame's.  Under
  --recover only host 0 reads the checkpoint and, with more than one
  process, broadcasts (image, alpha, done); only host 0 saves.  Without
  a mesh the frame is a one-slot mesh of `device`;
- under a torch profiler a frame records its spans (frame,
  frame.enqueue, tile, tile.rays, tile.integrate, tile.filter, tile.pull,
  tile.deliver, frame.imager; a replayed tile has tile.rays for its draws
  and tile.integrate for its replay, and tile.capture where it was
  captured in the same frame), its host syncs (base/timer.py,
  device.host_sync: one wait a pulled tile; the subpixel table and its
  weights are copied to a replica once, in its first frame) and its
  graph_tiles, the tiles that replayed a graph.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from lucille_tpu_torch.base.log import LOG_INFO, LOG_WARN, log
from lucille_tpu_torch.base.stats import RenderStats
from lucille_tpu_torch.base.timer import get_timer
from lucille_tpu_torch.device import host_sync, resolve_device
from lucille_tpu_torch.imageio.loader import load_image
from lucille_tpu_torch.lights.tables import build_light_tables
from lucille_tpu_torch.parallel.distributed import (
    broadcast_from_primary,
    is_primary_host,
    process_count,
)
from lucille_tpu_torch.parallel.mesh import Mesh, sharded_tile_batch
from lucille_tpu_torch.render.film import subsample_filter_table
from lucille_tpu_torch.render.graphs import (
    NotingStream,
    SeenTile,
    TileGraph,
    camera_key,
    capture_tile,
)
from lucille_tpu_torch.render.tiles import tile_list
from lucille_tpu_torch.ri.camera import generate_rays
from lucille_tpu_torch.sampling.hammersley import subpixel_samples
from lucille_tpu_torch.sampling.jitter import TileSampler
from lucille_tpu_torch.scene.compile import compile_arrays
from lucille_tpu_torch.scene.types import from_numpy
from lucille_tpu_torch.shading.pipeline import (
    Atmosphere,
    apply_imager,
    displace_scene,
)
from lucille_tpu_torch.texture.texture import TextureAtlas
from lucille_tpu_torch.transport.dispatch import SHADER_NAMES, get_integrator
from lucille_tpu_torch.transport.shaded import build_shader_table

LENS_FOLD = 0x10EF  # the lens samples' stream path (lucille_tpu's fold_in)


def tile_eye_rays(camera, x0: int, y0: int, tile_w: int, tile_h: int,
                  subpixel: torch.Tensor, lens_u=None):
    """Eye rays of one full-size tile, (tile_h, tile_w, S) raster-major:
    pixel corner + subpixel offset (S, 2) in f32, as lucille_tpu's tile
    kernel forms them; lens_u (B, 2) the thin lens's samples when the
    camera has depth of field.  Returns (org, dirn), each (B, 3)."""
    dev = subpixel.device
    xs = torch.arange(tile_w, dtype=torch.float32, device=dev) + float(x0)
    ys = torch.arange(tile_h, dtype=torch.float32, device=dev) + float(y0)
    shape = (tile_h, tile_w, subpixel.shape[0])
    fx = (xs[None, :, None] + subpixel[:, 0][None, None, :]).expand(shape)
    fy = (ys[:, None, None] + subpixel[:, 1][None, None, :]).expand(shape)
    return generate_rays(camera, fx.reshape(-1), fy.reshape(-1), lens_u)


class Renderer:
    """Holds the compiled scene, camera and sampler; renders frames.

    sampler: callable (x0, y0) -> the tile's random stream on `device`
    (sampling/jitter.py); defaults to TileSampler(seed, device).

    mesh: a parallel.mesh.Mesh, or None for the one `device`.  With a
    mesh, each device this process owns in it gets a replica of the
    render state and the tiles go in rounds of the mesh's size (module
    docstring); `device` is then the first replica's.  The attributes
    scene, textures, lights, atmosphere, shader_table and sampler are
    the first replica's."""

    def __init__(self, desc, tile_size: int = 64, device="cuda",
                 sampler: Optional[Callable] = None, seed: int = 0,
                 mesh=None):
        self.desc = desc
        self.tile_size = int(tile_size)
        self.mesh = mesh
        self._slots = mesh or Mesh([resolve_device(device)], [0])
        devices = [resolve_device(self._slots.devices[s])
                   for s in self._slots.owned]
        self.device = devices[0]
        self.integrator = get_integrator(
            (desc.options.render_method or "").lower())
        # the .sl shaders compiled for this Renderer, by (name, kind): its
        # surfaces and its other stages (shading/sl.find_sl)
        self.shaders = {}
        timer = get_timer()
        timer.start("Scene compile")
        displace_scene(desc, self.shaders)  # the bound displacement shaders
        images = _texture_images(desc)
        atlases = [TextureAtlas.build(images, dev) for dev in devices]
        # the host arrays once (the tile BVH built once), tensors per device
        arrays = compile_arrays(desc, texture_ids=dict(atlases[0].names))
        timer.end("Scene compile")
        self.camera = desc.camera
        self.replicas = [
            self._replica(dev, from_numpy(arrays, dev), atlas, sampler, seed)
            for dev, atlas in zip(devices, atlases)]
        first = self.replicas[0]
        self.scene, self.textures, self.lights = (first.scene, first.textures,
                                                  first.lights)
        self.atmosphere, self.shader_table, self.sampler = (
            first.atmosphere, first.shader_table, first.sampler)
        self.stats = RenderStats()
        if mesh is not None:
            self._warm()

    def _replica(self, dev, scene, textures, sampler, seed):
        """The render state on `dev`: the scene and texture atlas given,
        the light tables (an area light's device tables with them), the
        frame's atmosphere (the first bound volume shader: the
        MOSAIC/Blender export binds one global fog), the shader table
        under the shader method, and the sampler answering on `dev`."""
        desc = self.desc
        g = next((g for g in desc.geoms if g.attrs.atmosphere), None)
        shader_table = (build_shader_table(desc, dev, self.shaders)
                        if (desc.options.render_method or "").lower()
                        in SHADER_NAMES else None)
        return SimpleNamespace(
            device=dev, scene=scene, textures=textures,
            lights=build_light_tables(desc, device=dev),
            atmosphere=None if g is None else Atmosphere(
                g.attrs.atmosphere, g.attrs.atmosphere_params,
                desc.options.searchpaths, dev, self.shaders),
            shader_table=shader_table,
            method_kwargs=({} if shader_table is None
                           else {"shader_table": shader_table}),
            sampler=(TileSampler(seed, dev) if sampler is None
                     else lambda x0, y0: _OnDevice(sampler(x0, y0), dev)),
            consts={},  # the subpixel table and weights, by their values
            graph_key=None,  # the frame key (`_frame_key`) of `graphs`
            graphs_here=dev.type == "cuda",  # tile graphs run on a card
            graphs={},  # tile rectangle -> SeenTile, TileGraph or None
            graph_pool=None)  # the tile graphs' memory pool, made at need

    def _warm(self):
        """Render the frame's first tile on every card's replica and drop
        it: the per-device constants (device.const_vec, noise._perm,
        bvh_ao._device_consts, _away, the subpixel table) are copied to
        each card here, not inside a frame's first tile there; where the
        integrator allows graphs, this is the tile's first sight, so the
        first frame captures it (`_tile`)."""
        opt = self.desc.options
        x0, y0 = tile_list(opt.width, opt.height, self.tile_size,
                           opt.bucket_order)[0][:2]
        jitter_np, weights_np = self._subsamples()[2:]
        graphs = self._graph_frame(jitter_np, weights_np)
        for rep in self.replicas:
            if rep.device.type == "cuda":
                with torch.cuda.device(rep.device):
                    self._tile(x0, y0, self.tile_size, self.tile_size,
                               *self._consts(rep, jitter_np, weights_np),
                               rep, graphs)

    def _subsamples(self):
        """(xsamples, ysamples, the subpixel positions (S, 2), their
        pixel-filter weights (S,)) of the current display."""
        opt = self.desc.options
        disp = opt.current_display()
        xsamples = int(disp.sampling_rates[0])
        ysamples = int(disp.sampling_rates[1])
        jitter_np, _instance = subpixel_samples(xsamples, ysamples)
        weights_np = subsample_filter_table(opt.pixel_filter, jitter_np,
                                            *opt.pixel_filter_width)
        return xsamples, ysamples, jitter_np, weights_np

    def _consts(self, rep, jitter_np, weights_np):
        """The subpixel positions and their weights on rep's device,
        copied there once for each distinct table (`_on_device`); a tile
        graph reads them in place."""
        key = (jitter_np.tobytes(), weights_np.tobytes())
        if key not in rep.consts:
            rep.consts[key] = _on_device(jitter_np, weights_np, rep.device)
        return rep.consts[key]

    def _graph_frame(self, jitter_np, weights_np) -> bool:
        """Whether the frame's tiles may run as graphs (its integrator is
        capturable).  A replica whose graphs were captured under another
        frame key drops them, and their memory pool, first: a replica
        holds the graphs of one view at a time."""
        key = self._frame_key(jitter_np, weights_np)
        for rep in self.replicas:
            if rep.graph_key != key:
                rep.graph_key, rep.graphs, rep.graph_pool = key, {}, None
        return key is not None

    def _frame_key(self, jitter_np, weights_np):
        """The part of a tile graph's key that is the same for every tile
        of a frame: everything a tile's Python reads but its origin, size
        and replica (render method, the options passed to the integrator,
        the imager's alpha channel, the camera, the subpixel table and
        weights, the integrator's own switches).  None where the
        integrator does not declare itself capturable (`graph_key`)."""
        graph_key = getattr(self.integrator, "graph_key", None)
        if graph_key is None:
            return None
        opt = self.desc.options
        return ((opt.render_method or "").lower(), opt.gather_nsamples,
                opt.max_ray_depth, tuple(opt.bgcolor), bool(opt.imager),
                camera_key(self.camera), jitter_np.tobytes(),
                weights_np.tobytes(), graph_key())

    def _tile(self, x0, y0, tile_w, tile_h, jitter, weights, rep,
              graphs=False):
        """One full-size tile on replica rep (jitter and weights on its
        device) -> ((tile_h, tile_w, 3) image, with an imager (tile_h,
        tile_w, 4): its alpha rides as a fourth channel, so one copy
        pulls both; counters [ntests, ntrav, nrays] i64), both still on
        the device.  graphs: the frame may run its tiles as graphs
        (`_graph_frame`).  Then, on a card, rep.graphs holds what the
        replica knows of the tile, by its rectangle: nothing the first
        time (the tile renders eagerly, its draws and launch functions
        noted in a SeenTile); the second time it is captured and replayed,
        and from then on replayed (a TileGraph); None where its capture
        failed (render/graphs.py)."""
        timer = get_timer()
        key = (x0, y0, tile_w, tile_h) if graphs and rep.graphs_here else None
        held = rep.graphs.get(key)
        with timer.span("tile", x0=x0, y0=y0):
            if isinstance(held, SeenTile) and held.capturable():
                with timer.span("tile.capture"):
                    if rep.graph_pool is None:
                        rep.graph_pool = torch.cuda.graph_pool_handle()
                    held = rep.graphs[key] = capture_tile(
                        lambda stream: self._tile_work(
                            x0, y0, tile_w, tile_h, jitter, weights, rep,
                            stream),
                        held, rep.device, rep.graph_pool)
            if isinstance(held, TileGraph) and held.replayable():
                with timer.span("tile.rays"):
                    held.recorder.refill(rep.sampler(x0, y0))
                with timer.span("tile.integrate"):
                    out = held.replay()
                timer.count("graph_tiles")
                return out
            if key is None or key in rep.graphs:
                return self._tile_work(x0, y0, tile_w, tile_h, jitter,
                                       weights, rep)
            noting = NotingStream(rep.sampler(x0, y0))
            with timer.recording_launches() as launches:
                out = self._tile_work(x0, y0, tile_w, tile_h, jitter,
                                      weights, rep, noting)
            rep.graphs[key] = SeenTile(noting.draws, launches)
            return out

    def _tile_work(self, x0, y0, tile_w, tile_h, jitter, weights, rep,
                   stream=None):
        """The tile's work (`_tile`) with its random stream (by default
        the replica's sampler's, for the tile's origin)."""
        S = jitter.shape[0]
        opt = self.desc.options
        timer = get_timer()
        with timer.span("tile.rays"):
            if stream is None:
                stream = rep.sampler(x0, y0)
            lens_u = None
            if self.camera.dof_active:
                lens_u = stream.uniform((LENS_FOLD,),
                                        (tile_h * tile_w * S, 2))
            org, dirn = tile_eye_rays(self.camera, x0, y0, tile_w,
                                      tile_h, jitter, lens_u)
        with timer.span("tile.integrate"):
            radiance, aux = self.integrator(
                rep.scene, rep.lights, org, dirn, stream,
                gather_nsamples=opt.gather_nsamples,
                max_depth=opt.max_ray_depth, bgcolor=tuple(opt.bgcolor),
                textures=rep.textures, **rep.method_kwargs,
            )
        with timer.span("tile.filter"):
            return self._filter(radiance, aux, org, dirn, tile_w, tile_h,
                                weights, rep)

    def _filter(self, radiance, aux, org, dirn, tile_w, tile_h, weights,
                rep):
        """The tile's integrator output -> (image, counters) on the device
        (`_tile`): the atmosphere, the pixel filter, the counters and, with
        an imager, the alpha channel."""
        S = weights.shape[0]
        if rep.atmosphere is not None and aux.get("t") is not None:
            hit = aux["hit"]
            t = torch.where(hit, aux["t"], 0.0)
            ray_len = t * torch.linalg.vector_norm(dirn, dim=-1)
            radiance = rep.atmosphere(radiance, ray_len,
                                      org + t[:, None] * dirn, hit, dirn)
        r = radiance.reshape(tile_h, tile_w, S, 3)
        img = torch.sum(r * weights[None, None, :, None], dim=2)
        # a missing counter is filled on the device: copying a host 0 there
        # would wait for every tile already enqueued
        counters = torch.stack([
            aux[k].to(torch.int64) if torch.is_tensor(aux.get(k))
            else torch.full((), int(aux.get(k, 0)), dtype=torch.int64,
                            device=rep.device)
            for k in ("ntests", "ntrav", "nrays")
        ])
        if self.desc.options.imager:  # the imager's coverage
            alpha = aux["hit"].reshape(tile_h, tile_w, S).to(
                torch.float32).mean(dim=2)
            img = torch.cat([img, alpha[..., None]], dim=-1)
        return img, counters

    def render_frame(self, tile_cb: Optional[Callable] = None,
                     progress_cb: Optional[Callable] = None,
                     checkpoint: Optional[str] = None,
                     recover: bool = False) -> np.ndarray:
        """Render the frame; returns (H, W, 3) f32 in raster order (row 0
        is raster y 0; the hdr file driver flips).  checkpoint: a tile
        checkpoint file's path; recover: resume from it (module
        docstring).  Under a mesh that spans processes every process
        calls it and gets the whole frame.  Under a torch profiler the
        frame records its spans and host syncs (base/timer.py)."""
        with get_timer().frame():
            return self._render_frame(tile_cb, progress_cb, checkpoint,
                                      recover)

    def _render_frame(self, tile_cb, progress_cb, checkpoint, recover):
        opt = self.desc.options
        W, H = opt.width, opt.height
        xsamples, ysamples, jitter_np, weights_np = self._subsamples()
        consts = [self._consts(rep, jitter_np, weights_np)
                  for rep in self.replicas]
        graphs = self._graph_frame(jitter_np, weights_np)

        # RiCropWindow -> raster rect [ceil(W*xmin), ceil(W*xmax) - 1]
        cxmin, cxmax, cymin, cymax = self.camera.crop_window
        crop_px0 = max(0, int(np.ceil(W * cxmin)))
        crop_px1 = min(W, max(crop_px0 + 1, int(np.ceil(W * cxmax))))
        crop_py0 = max(0, int(np.ceil(H * cymin)))
        crop_py1 = min(H, max(crop_py0 + 1, int(np.ceil(H * cymax))))
        cropped = (crop_px0, crop_py0, crop_px1, crop_py1) != (0, 0, W, H)

        tile_w = tile_h = self.tile_size
        tiles = tile_list(W, H, self.tile_size, opt.bucket_order)
        if cropped:
            tiles = [
                (x0, y0, i, j) for (x0, y0, i, j) in tiles
                if x0 < crop_px1 and x0 + tile_w > crop_px0
                and y0 < crop_py1 and y0 + tile_h > crop_py0
            ]

        image = np.zeros((H, W, 3), dtype=np.float32)
        alpha = np.zeros((H, W), dtype=np.float32)  # the imager's coverage
        meta = np.asarray([W, H, tile_w, tile_h, xsamples, ysamples,
                           len(tiles)], dtype=np.int64)
        done = np.zeros(len(tiles), dtype=bool)
        if checkpoint and recover:
            # host 0 reads the file and ships what it found, so every
            # process skips the same tiles (the file may exist only there)
            if is_primary_host():
                image, alpha, done = _recover(checkpoint, meta, image, alpha,
                                              done)
            if process_count() > 1:
                image, alpha, done = broadcast_from_primary(
                    (image, alpha, done.astype(np.uint8)))
                done = done.astype(bool)

        def save_checkpoint():
            if not is_primary_host():
                return  # host 0 owns the checkpoint as it owns the displays
            tmp = checkpoint + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, image=image, done=done, meta=meta, alpha=alpha)
            os.replace(tmp, checkpoint)  # atomic against a crash mid-write

        first = self._slots.owned[0]

        def tile_fn(slot, x0, y0):
            i = slot - first
            return self._tile(x0, y0, tile_w, tile_h, *consts[i],
                              self.replicas[i], graphs)

        timer = get_timer()
        timer.count("graph_tiles", 0)  # a frame of eager tiles counts 0
        timer.start("Render frame")
        # the tiles not done, in rounds of the mesh's size, every round
        # enqueued before the first pull: the devices run ahead of the pulls
        enqueue = sharded_tile_batch(self._slots, tile_fn)
        todo = [ti for ti in range(len(tiles)) if not done[ti]]
        pending = [None] * len(tiles)
        D = self._slots.size
        with timer.span("frame.enqueue"):
            for s in range(0, len(todo), D):
                group = todo[s : s + D]
                rnd = enqueue([tiles[ti][:2] for ti in group])
                for slot, ti in enumerate(group):
                    pending[ti] = (rnd, slot)
        totals = np.zeros(3, dtype=np.int64)
        for ti, (x0, y0, _i, _j) in enumerate(tiles):
            th = min(tile_h, H - y0)
            tw = min(tile_w, W - x0)
            if pending[ti] is None:  # recovered: replay to the callbacks
                with timer.span("tile.deliver"):
                    if tile_cb:
                        tile_cb(x0, y0, image[y0 : y0 + th, x0 : x0 + tw])
                    if progress_cb:
                        progress_cb((ti + 1) / len(tiles))
                continue
            rnd, slot = pending[ti]
            tile_np, counters = rnd.get(slot)  # span tile.pull
            with timer.span("tile.deliver"):
                totals += counters
                tile_alpha = None
                if tile_np.shape[-1] == 4:  # the imager's alpha channel
                    tile_np, tile_alpha = tile_np[..., :3], tile_np[..., 3]
                if cropped:
                    wy0, wy1 = max(y0, crop_py0), min(y0 + th, crop_py1)
                    wx0, wx1 = max(x0, crop_px0), min(x0 + tw, crop_px1)
                    window = (slice(wy0 - y0, wy1 - y0),
                              slice(wx0 - x0, wx1 - x0))
                    image[wy0:wy1, wx0:wx1] = tile_np[window]
                    if tile_alpha is not None:
                        alpha[wy0:wy1, wx0:wx1] = tile_alpha[window]
                else:
                    image[y0 : y0 + th, x0 : x0 + tw] = tile_np[:th, :tw]
                    if tile_alpha is not None:
                        alpha[y0 : y0 + th, x0 : x0 + tw] = (
                            tile_alpha[:th, :tw])
                done[ti] = True
                if checkpoint:
                    save_checkpoint()
                if tile_cb:
                    tile_cb(x0, y0, tile_np[:th, :tw])
                if progress_cb:
                    progress_cb((ti + 1) / len(tiles))
        if checkpoint and is_primary_host() and os.path.exists(checkpoint):
            os.remove(checkpoint)  # the frame is complete
        if opt.imager:  # the film post-pass over the assembled frame
            timer.start("Imager")
            with timer.span("frame.imager"):
                image = np.asarray(apply_imager(image, alpha, opt.imager,
                                                opt.imager_params,
                                                opt.searchpaths, self.device,
                                                self.shaders),
                                   dtype=np.float32)
            timer.end("Imager")
        self.stats.render_seconds += timer.end("Render frame")
        self.stats.add(nrays=int(totals[2]), ntriangle_tests=int(totals[0]),
                       ntraversals=int(totals[1]))
        log(LOG_INFO, "frame done: %d tiles, %.2f Mrays/s", len(tiles),
            self.stats.mrays_per_sec)
        return image


class _OnDevice:
    """A caller's tile stream whose draws are moved to `device` (a no-op
    where they already lie there), so a replica's sampler answers on the
    replica's device."""

    def __init__(self, stream, device):
        self.stream, self.device = stream, device

    def uniform(self, path, shape) -> torch.Tensor:
        return self.stream.uniform(path, shape).to(self.device)

    def randint(self, path, shape, high: int) -> torch.Tensor:
        return self.stream.randint(path, shape, high).to(self.device)


def _on_device(jitter_np, weights_np, device):
    """The subpixel positions and their weights as f32 tensors on
    `device` (two host syncs; once a replica, Renderer._consts)."""
    return (host_sync(torch.Tensor.to,
                      torch.tensor(jitter_np, dtype=torch.float32), device),
            host_sync(torch.Tensor.to, torch.from_numpy(weights_np), device))


def _recover(checkpoint: str, meta, image, alpha, done):
    """(image, alpha, done) from a checkpoint file that matches the
    frame's meta (alpha as given where the file has none); the given
    ones, with a warning, when the file is absent, does not match or
    cannot be read."""
    if not os.path.exists(checkpoint):
        return image, alpha, done
    try:
        with np.load(checkpoint) as data:
            if not np.array_equal(data["meta"], meta):
                log(LOG_WARN, "checkpoint %s does not match this frame; "
                    "ignoring", checkpoint)
                return image, alpha, done
            got_image = np.asarray(data["image"], dtype=np.float32)
            got_done = np.asarray(data["done"], dtype=bool)
            if "alpha" in data:
                alpha = np.asarray(data["alpha"], dtype=np.float32)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
        log(LOG_WARN, "cannot read checkpoint %s: %s", checkpoint, e)
        return image, alpha, done
    log(LOG_INFO, "recovered %d/%d finished tiles from %s",
        int(got_done.sum()), len(got_done), checkpoint)
    return got_image, alpha, got_done


def _texture_images(desc) -> dict:
    """Every material texture, found through the option's search paths
    (then as given), as {name: (h, w, 3) array}; a texture that is
    missing or cannot be read is logged and left out (its materials keep
    id -1 in the atlas)."""
    names = {g.attrs.material.texture for g in desc.geoms
             if g.attrs.material.texture}
    images = {}
    for name in sorted(names):
        found = next((Path(sp) / name
                      for sp in desc.options.searchpaths or ["."]
                      if (Path(sp) / name).exists()), None)
        if found is None and Path(name).exists():
            found = Path(name)
        if found is None:
            log(LOG_WARN, "texture '%s' not found on searchpath; ignoring",
                name)
            continue
        try:
            images[name] = load_image(found)
        except (ValueError, OSError) as e:
            log(LOG_WARN, "cannot load texture '%s': %s", name, e)
    return images
