"""Surface shaders as torch functions over a hit wavefront.

Counterpart of lucille_tpu/shading/shader.py (the reference's shader ABI,
render/shader.h:27-120, and its built-ins, render/shader.c:488-925):

    shader(sg: ShaderGlobals, params: dict, ctx: ShaderContext)
        -> (Ci (B, 3), Oi (B, 3))

`ShaderGlobals` carries the RSL globals as tensors of one wavefront;
`ShaderContext` gives the built-ins that need the scene (`ambient`,
`occlusion`, `diffuse`, `specular`, `texture`, `trace`) over the port's
accels and light sampling, with the tile's random stream
(sampling/jitter.StreamKey) where lucille_tpu takes a `jax.random` key,
folded at the same places: stratum si of `occlusion` at key.fold(si);
`diffuse` and `specular` both at the context's own key, as lucille_tpu's
pass theirs (inside them each light folds i + 1000, lights/sampling.py).

The six built-in surfaces are lucille_tpu's, with its registry defaults
(`BUILTINS`).  There is no process-wide registry: `get_shader` resolves a
built-in's name, and an unknown name warns once and falls back to matte;
a Renderer's compiled .sl surfaces are resolved by
transport/shaded.build_shader_table.

Parameters are bound once per Renderer (`bind_params`), not inside a
tile: a number stays a 0-d f32 tensor on the host (a uniform value, read
without a device sync), any other numeric value (a colour, a RIB array)
becomes an f32 tensor on the device, copied there once.  The built-ins'
own defaults that lucille_tpu reads inside the shader (plastic's
specularcolor, checker's colours and frequency) are bound the same way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from lucille_tpu_torch.accel.dispatch import any_hit
from lucille_tpu_torch.base.log import LOG_WARN, log_once
from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.lights.sampling import direct_diffuse, direct_specular
from lucille_tpu_torch.ops.frame import ortho_basis
from lucille_tpu_torch.shading.reflection import reflect


@dataclass
class ShaderGlobals:
    """The RSL globals of one wavefront (render/shader.h ri_input_t)."""

    P: Any  # (B, 3) surface point
    N: Any  # (B, 3) shading normal
    Ng: Any  # (B, 3) geometric normal
    I: Any  # (B, 3) incident ray direction (toward the surface)
    E: Any  # (B, 3) eye / ray origin
    Cs: Any  # (B, 3) surface colour
    Os: Any  # (B, 3) surface opacity
    s: Any  # (B,) texture coordinates
    t: Any  # (B,)
    u: Any  # (B,) barycentric u
    v: Any  # (B,)
    dPdu: Any  # (B, 3) tangent
    dPdv: Any  # (B, 3) binormal


@dataclass
class ShaderContext:
    """Scene access for the shader built-ins, one per wavefront: scene,
    key (a sampling/jitter.StreamKey), lights (lights/tables.LightTables),
    textures (texture/texture.TextureAtlas), trace_depth_left and the
    integrator's trace_fn."""

    scene: Any
    key: Any
    lights: Any = None
    textures: Any = None
    nsamples_occlusion: int = 16
    trace_depth_left: int = 0
    trace_fn: Callable | None = None

    def ambient(self, sg: ShaderGlobals):
        """ambient() (shader.c:488): the scene's ambient light, zero."""
        return torch.zeros_like(sg.P)

    def occlusion(self, sg: ShaderGlobals, nsamples: int | None = None):
        """occlusion(P, N, samples) (shaders/ambientocclusion.sl): the
        blocked fraction of the hemisphere, (B,), over ntheta^2 strata,
        ntheta = max(1, int(sqrt(n))); stratum si draws key.fold(si) and
        traces one any-hit wavefront from P + N eps over every lane."""
        n = nsamples or self.nsamples_occlusion
        ntheta = max(1, int(n ** 0.5))
        b0, b1, b2 = ortho_basis(sg.N)
        org = sg.P + sg.N * self.scene.eps
        B = sg.P.shape[0]
        occ = torch.zeros((B,), dtype=torch.float32, device=sg.P.device)
        for si in range(ntheta * ntheta):
            i, j = float(si % ntheta), float(si // ntheta)
            ur = self.key.fold(si).uniform((B, 2))
            z0 = (i + ur[:, 0]) / ntheta
            z1 = (j + ur[:, 1]) / ntheta
            cos_t = torch.sqrt(z0)
            phi = (2.0 * math.pi) * z1
            lx = torch.cos(phi) * cos_t
            ly = torch.sin(phi) * cos_t
            lz = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
            d = lx[..., None] * b0 + ly[..., None] * b1 + lz[..., None] * b2
            occ = occ + any_hit(self.scene, org, d)["occ"].to(torch.float32)
        return occ / (ntheta * ntheta)

    def diffuse(self, sg: ShaderGlobals):
        """diffuse(N) (shader.c:504): lights/sampling.direct_diffuse."""
        if self.lights is None:
            log_once(LOG_WARN, "diffuse() with no lights: returning 0")
            return torch.zeros_like(sg.P)
        return direct_diffuse(self.scene, self.lights, sg.P, sg.N, self.key)

    def specular(self, sg: ShaderGlobals, roughness):
        """specular(N, V, roughness) (shader.c:529) with V = -I; a uniform
        roughness (a host tensor) is handed on as a Python number."""
        if self.lights is None:
            return torch.zeros_like(sg.P)
        if torch.is_tensor(roughness) and roughness.device != sg.P.device:
            roughness = float(roughness)
        return direct_specular(self.scene, self.lights, sg.P, sg.N, -sg.I,
                               roughness, self.key)

    def texture(self, name_or_id, s, t):
        """texture(name, s, t) (shader.c:634) through the atlas: white
        where there is none.  lucille_tpu's fetch of a texture named in
        the shader fails on an atlas that holds textures (it reads the
        name as an id), and so does the port's: a shader's texture
        names are not looked up."""
        if self.textures is None:
            log_once(LOG_WARN, "texture() with no atlas: returning 1")
            return torch.ones(s.shape + (3,), dtype=torch.float32,
                              device=s.device)
        if isinstance(name_or_id, str) and self.textures.data is not None:
            raise NotImplementedError(
                f"texture({name_or_id!r}) in a shader: a texture named in "
                "a shader is not looked up in the atlas (lucille_tpu's "
                "fetch fails the same way)")
        return self.textures.fetch(name_or_id, s, t)

    def trace(self, sg: ShaderGlobals, dirn):
        """trace(P, dir) (shader.c:895-925): the radiance of a secondary
        wavefront, bounded by trace_depth_left; the origin is offset
        along the traced direction (shader.c:918-921), so refraction
        rays cross the surface."""
        if self.trace_fn is None or self.trace_depth_left <= 0:
            return torch.zeros_like(sg.P)
        return self.trace_fn(sg.P + dirn * self.scene.eps, dirn)


# -- parameters ------------------------------------------------------------

def param_value(val, device):
    """One parameter as a shader reads it: a string as is; a tensor as
    given; a number as a 0-d f32 host tensor; any other numeric value as
    an f32 tensor on `device`, copied there once (device.const_vec)."""
    if isinstance(val, str) or torch.is_tensor(val):
        return val
    arr = np.array(val, dtype=np.float32)
    if arr.ndim == 0:
        return torch.from_numpy(arr)
    return const_vec(arr.reshape(-1), device).reshape(arr.shape)


def bind_params(fn, params: dict, device) -> dict:
    """params as `fn` reads them on `device` (module docstring): a
    compiled .sl shader binds through its own `bind`; a built-in's
    in-shader defaults are bound under params, and a count it reads as
    an int stays a host int."""
    if hasattr(fn, "bind"):
        return fn.bind(params, device)
    merged = dict(_INNER_DEFAULTS.get(fn, {}))
    merged.update(params)
    return {k: (_host_int(v) if k in _INT_PARAMS.get(fn, ()) else
                param_value(v, device)) for k, v in merged.items()}


def _host_int(v) -> int:
    """int(v), a one-value RIB array read as its value."""
    return int(np.asarray(v, np.float64).reshape(-1)[0])


def _param(params, name, default, device):
    """A bound parameter (bind_params), or its default bound on `device`."""
    v = params.get(name, default)
    return v if torch.is_tensor(v) else param_value(v, device)


# -- the built-in shader library (counterparts of shaders/*.sl) ------------

def matte_shader(sg, params, ctx):
    """shaders/matte.sl: Ci = Cs (Ka ambient() + Kd diffuse(N))."""
    dev = sg.P.device
    ka = _param(params, "Ka", 1.0, dev)
    kd = _param(params, "Kd", 1.0, dev)
    ci = sg.Cs * (ka * ctx.ambient(sg) + kd * ctx.diffuse(sg))
    return ci, sg.Os


def constant_shader(sg, params, ctx):
    """shaders/constant.sl: Ci = Cs."""
    del params, ctx
    return sg.Cs, sg.Os


def plastic_shader(sg, params, ctx):
    """shaders/plastic.sl."""
    dev = sg.P.device
    ka = _param(params, "Ka", 1.0, dev)
    kd = _param(params, "Kd", 0.5, dev)
    ks = _param(params, "Ks", 0.5, dev)
    roughness = _param(params, "roughness", 0.1, dev)
    speccolor = _param(params, "specularcolor", [1.0, 1.0, 1.0], dev)
    ci = sg.Cs * (ka * ctx.ambient(sg) + kd * ctx.diffuse(sg)) + (
        ks * speccolor * ctx.specular(sg, roughness))
    return ci, sg.Os


def checker_shader(sg, params, ctx):
    """shaders/checker.sl: a procedural checkerboard over (s, t)."""
    dev = sg.P.device
    freq = _param(params, "frequency", 10.0, dev)
    dark = _param(params, "darkcolor", [0.1, 0.1, 0.1], dev)
    light = _param(params, "lightcolor", [1.0, 1.0, 1.0], dev)
    sc = torch.floor(sg.s * freq).to(torch.int32)
    tc = torch.floor(sg.t * freq).to(torch.int32)
    odd = torch.remainder(sc + tc, 2).to(torch.float32)[..., None]
    base = odd * dark + (1.0 - odd) * light
    return base * ctx.diffuse(sg), sg.Os


def ambientocclusion_shader(sg, params, ctx):
    """shaders/ambientocclusion.sl: Ci = Cs (1 - occlusion(P, N, n)),
    n read as an int (lucille_tpu's int() of the parameter; a one-value
    RIB array, which lucille_tpu's int() refuses, is read as its value)."""
    occ = ctx.occlusion(sg, _host_int(params.get("samples", 64)))
    return sg.Cs * (1.0 - occ)[..., None], sg.Os


def mirror_shader(sg, params, ctx):
    """An ideal mirror through trace() (shaders/whitted.sl capability)."""
    dev = sg.P.device
    kr = _param(params, "Kr", 1.0, dev)
    return kr * ctx.trace(sg, reflect(sg.I, sg.N)), sg.Os


# name -> (fn, registry defaults): lucille_tpu's register_shader calls
BUILTINS = {
    "matte": (matte_shader, {"Ka": 1.0, "Kd": 1.0}),
    "constant": (constant_shader, {}),
    "plastic": (plastic_shader,
                {"Ka": 1.0, "Kd": 0.5, "Ks": 0.5, "roughness": 0.1}),
    "checker": (checker_shader, {}),
    "ambientocclusion": (ambientocclusion_shader, {"samples": 64}),
    "mirror": (mirror_shader, {"Kr": 1.0}),
}
# the counts the built-ins read as ints (kept on the host)
_INT_PARAMS = {ambientocclusion_shader: ("samples",)}
# the defaults the built-ins read inside the shader (`_param`), bound with
# the parameters so that no tile copies one to the device
_INNER_DEFAULTS = {
    plastic_shader: {"specularcolor": [1.0, 1.0, 1.0]},
    checker_shader: {"frequency": 10.0, "darkcolor": [0.1, 0.1, 0.1],
                     "lightcolor": [1.0, 1.0, 1.0]},
}


def get_shader(name: str | None):
    """Resolve a built-in Surface name to (fn, default params), else matte
    with a warning (the reference's fixed-pipeline fallback when a DSO
    fails to load, attribute.c:322-337)."""
    key = (name or "").lower()
    if key in BUILTINS:
        return BUILTINS[key]
    if name:
        log_once(LOG_WARN, "unknown surface shader '%s'; using matte", name)
    return BUILTINS["matte"]
