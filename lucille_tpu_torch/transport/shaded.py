"""The shader integrator: each geometry's bound surface shader evaluated
at the hits of a wavefront, in torch.

Counterpart of lucille_tpu/transport/shaded.py, the path the reference
meant to take (ri_shade -> shader_shading -> shaderproc, shading.c:85-151,
short-circuited by `#if 0` in the C tree): a geometry's Surface binding,
a built-in (shading/shader.py) or RSL compiled from its .sl
(shading/sl.py), runs over the hit wavefront.

- Masked-dense, as lucille_tpu: each distinct (shader, parameters) pair
  runs once over the whole wavefront, and a lane takes its geometry's
  result (`h["geom"]`); a lane that missed takes `background_radiance`.
- `trace()` is live: a wavefront's context re-shades the traced rays as
  a wavefront of their own one level down, at key.fold(depth), at most 3
  deep (the reference's trace() refuses past ray depth 3,
  shader.c:911-914); whitted.sl, tracing twice a level, shades 15
  wavefronts from a depth of 3.
- aux carries hit, t, ntests and ntrav of the wavefront's closest hit and
  nrays = B, the wavefront's own rays, as lucille_tpu counts them.

`build_shader_table` resolves the bindings once per Renderer, compiling
each `<name>.sl` found on the option's search paths into the Renderer's
cache of compiled shaders (shading/sl.find_sl; nothing process-wide),
and binds every row's parameters on the render device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lucille_tpu_torch.accel.dispatch import closest_hit
from lucille_tpu_torch.base.log import LOG_WARN, log_once
from lucille_tpu_torch.ops.frame import ortho_basis
from lucille_tpu_torch.shading.shader import (
    BUILTINS,
    ShaderContext,
    ShaderGlobals,
    bind_params,
    get_shader,
)
from lucille_tpu_torch.shading.sl import find_sl
from lucille_tpu_torch.transport.common import (
    background_radiance,
    face_forward,
    interp_hit,
)

MAX_TRACE_DEPTH = 3  # shader.c:911-914


class ShaderRow(NamedTuple):
    """One geometry's binding: its shader, its parameters with the
    shader's defaults merged under them (lucille_tpu's row), and those
    parameters bound on the render device (shading/shader.bind_params)."""

    fn: Callable
    params: dict
    bound: dict


def shaded_radiance(scene, lights, org, dirn, key, shader_table=None,
                    max_depth: int = 8, bgcolor=(0.0, 0.0, 0.0),
                    textures=None):
    """Shade the hits of the wavefront org, dirn (B, 3) by their
    geometries' surface shaders.  key: a sampling/jitter.StreamKey;
    shader_table: a list of ShaderRow by geometry id
    (`build_shader_table`), None for matte everywhere.  Returns
    (radiance (B, 3), aux {hit, nrays, ntests, ntrav, t})."""
    if shader_table is None:
        fn, defaults = get_shader("matte")
        row = ShaderRow(fn, dict(defaults),
                        bind_params(fn, defaults, org.device))
        shader_table = [row] * scene.n_geoms
    depth = min(max_depth, MAX_TRACE_DEPTH)
    return _shade_wavefront(scene, lights, org, dirn, key, shader_table,
                            depth, bgcolor, textures)


def _row_key(row: ShaderRow):
    return (id(row.fn), tuple(sorted(map(str, row.params.items()))))


def _shade_wavefront(scene, lights, org, dirn, key, shader_table, depth,
                     bgcolor, textures):
    """One wavefront of shading; trace() recurses here."""
    B = org.shape[0]
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    h = interp_hit(scene, res, org, dirn)
    N = face_forward(h["Ns"], dirn)
    b0, b1, _ = ortho_basis(N)
    sg = ShaderGlobals(
        P=h["P"], N=N, Ng=h["Ng"], I=dirn, E=org,
        Cs=h["cs"] * h["mat_color"],
        Os=torch.ones((B, 3), dtype=torch.float32, device=org.device),
        s=h["st"][..., 0], t=h["st"][..., 1], u=res["u"], v=res["v"],
        dPdu=b0, dPdv=b1,
    )

    def trace_fn(torg, tdirn):
        # the traced rays are shaded as a wavefront one level down; rays
        # that escape see the background, as the reference's trace() does
        sub, _ = _shade_wavefront(scene, lights, torg, tdirn, key.fold(depth),
                                  shader_table, depth - 1, bgcolor, textures)
        return sub

    ctx = ShaderContext(scene=scene, key=key, lights=lights,
                        textures=textures, trace_depth_left=depth,
                        trace_fn=trace_fn if depth > 0 else None)

    # each distinct (shader, parameters) once over the whole wavefront
    ci = torch.zeros((B, 3), dtype=torch.float32, device=org.device)
    keys = [_row_key(row) for row in shader_table]
    done = set()
    for row, key_id in zip(shader_table, keys):
        if key_id in done:
            continue
        done.add(key_id)
        mask = None
        for g, k in enumerate(keys):
            if k == key_id:
                m = h["geom"] == g
                mask = m if mask is None else mask | m
        out_ci, _out_oi = row.fn(sg, row.bound, ctx)
        ci = torch.where((hit & mask)[:, None], out_ci, ci)

    env = background_radiance(lights, dirn, bgcolor)
    radiance = torch.where(hit[:, None], ci, env)
    return radiance, {"hit": hit, "nrays": B, "ntests": res["ntests"],
                      "ntrav": res["ntrav"], "t": res["t"]}


def build_shader_table(desc, device, cache: dict | None = None) -> list:
    """Each geometry's Surface binding as a ShaderRow (module docstring).

    Parameter names are normalised ('uniform float Kd' -> 'Kd'); a name
    that is not built in (a built-in wins over an .sl of its name, as in
    lucille_tpu) is compiled from '<name>.sl' on the option's search
    paths, once per `cache` (a Renderer's, by (name, kind); a fresh one
    by default); a source that does not compile, or that declares another
    name (lucille_tpu registers it under that one), falls back to matte
    with a warning, as an unknown name does."""
    cache = {} if cache is None else cache
    table = []
    for g in desc.geoms:
        name = g.attrs.surface
        params = {k.split()[-1]: v
                  for k, v in (g.attrs.surface_params or {}).items()}
        low = (name or "").lower()
        fn = None
        if name and low not in BUILTINS:
            fn = find_sl(name, "surface", desc.options.searchpaths, cache)
            if fn is not None and fn.shader_name.lower() != low:
                log_once(LOG_WARN, "'%s.sl' declares the surface '%s'; "
                         "using matte", name, fn.shader_name)
                fn = None
        fn, defaults = ((fn, fn.defaults) if fn is not None
                        else get_shader(name if low in BUILTINS else None))
        merged = dict(defaults)
        merged.update(params)
        table.append(ShaderRow(fn, merged, bind_params(fn, merged, device)))
    return table
