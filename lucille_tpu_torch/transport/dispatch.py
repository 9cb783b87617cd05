"""Integrator dispatch by render method.

Counterpart of lucille_tpu/transport/dispatch.py:17-79:

- "ao" (and "ambientocclusion", "mcraytrace", "default", ""), the
  reference's hardwired default (render.c:803);
- "whitted";
- "pathtrace", "path" and "mlt" ("mlt" warns once and path traces);
- "dirtmap", AO weighted by the occluders' distance (transport/
  dirtmap.py);
- "shader" (and "sl", "shade"), each geometry's surface shader at the
  hits (transport/shaded.py), with the Renderer's shader table;
- any other name warns once and renders AO.

Contract: fn(scene, lights, org, dirn, stream, *, gather_nsamples,
max_depth, bgcolor, textures) -> (radiance (B, 3), aux), as lucille_tpu's
fn(scene, lights, org, dirn, key, ...) with the tile's random stream
(sampling/jitter.py) in place of its key.  The renderer passes
max_depth = Option "trace" "max_ray_depth", the option's bgcolor and its
texture atlas (texture/texture.py) to every method, as lucille_tpu's
does (render/renderer.py:247-249); AO, Whitted, the path tracer and the
shaders read the atlas, the dirt map does not (nor does lucille_tpu's).
The shader method also takes `shader_table`, built once per Renderer
(transport/shaded.build_shader_table), as lucille_tpu's tile kernel
does (lucille_tpu/render/renderer.py:66-69).
"""

from __future__ import annotations

import math

from lucille_tpu_torch.base.log import LOG_WARN, log_once
from lucille_tpu_torch.sampling.jitter import StreamKey
from lucille_tpu_torch.transport.ao import ao_radiance
from lucille_tpu_torch.transport.dirtmap import dirtmap_radiance
from lucille_tpu_torch.transport.pathtrace import path_radiance
from lucille_tpu_torch.transport.shaded import shaded_radiance
from lucille_tpu_torch.transport.whitted import whitted_radiance

AO_NAMES = ("ao", "ambientocclusion", "mcraytrace", "default", "")
PATH_NAMES = ("pathtrace", "path", "mlt")
SHADER_NAMES = ("shader", "sl", "shade")


def get_integrator(name: str):
    name = (name or "").lower()
    if name in SHADER_NAMES:
        def shaded_fn(scene, lights, org, dirn, stream, *,
                      gather_nsamples: int = 64, max_depth: int = 8,
                      bgcolor=(0.0, 0.0, 0.0), textures=None,
                      shader_table=None):
            return shaded_radiance(scene, lights, org, dirn,
                                   StreamKey(stream),
                                   shader_table=shader_table,
                                   max_depth=max_depth, bgcolor=bgcolor,
                                   textures=textures)

        return shaded_fn
    if name == "whitted":
        def whitted_fn(scene, lights, org, dirn, stream, *,
                       gather_nsamples: int = 64, max_depth: int = 8,
                       bgcolor=(0.0, 0.0, 0.0), textures=None):
            return whitted_radiance(scene, lights, org, dirn,
                                    StreamKey(stream), max_depth=max_depth,
                                    bgcolor=bgcolor, textures=textures)

        return whitted_fn
    if name in PATH_NAMES:
        if name == "mlt":
            log_once(LOG_WARN, "method 'mlt' unimplemented; using pathtrace")

        def path_fn(scene, lights, org, dirn, stream, *,
                    gather_nsamples: int = 64, max_depth: int = 10,
                    bgcolor=(0.0, 0.0, 0.0), textures=None):
            return path_radiance(scene, lights, org, dirn, StreamKey(stream),
                                 max_depth=max_depth, bgcolor=bgcolor,
                                 textures=textures)

        return path_fn
    if name == "dirtmap":
        def dirt_fn(scene, lights, org, dirn, stream, *,
                    gather_nsamples: int = 64, max_depth: int = 8,
                    bgcolor=(0.0, 0.0, 0.0), textures=None):
            ntheta = max(1, int(math.sqrt(gather_nsamples)))
            return dirtmap_radiance(scene, org, dirn, stream, ntheta, ntheta)

        return dirt_fn
    if name not in AO_NAMES:
        log_once(LOG_WARN, "unknown render method '%s'; using AO", name)

    def ao_fn(scene, lights, org, dirn, stream, *, gather_nsamples: int = 64,
              max_depth: int = 8, bgcolor=(0.0, 0.0, 0.0), textures=None):
        ntheta = max(1, int(math.sqrt(gather_nsamples)))
        return ao_radiance(scene, org, dirn, stream, ntheta, ntheta,
                           lights=lights, textures=textures)

    return ao_fn
