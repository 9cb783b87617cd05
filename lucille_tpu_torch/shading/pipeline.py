"""Displacement / Atmosphere / Imager shader execution.

Counterpart of lucille_tpu/shading/pipeline.py.  The reference's shader
ABI (render/shader.h:27-120) spans more than surface shaders; this
module executes the other three stages the RIB can bind:

- **Displacement** (``RiDisplacement``): run over each geometry's
  VERTICES before the scene compile, on the host, as lucille_tpu does
  (MOSAICdisplace in NumPy, an .sl shader in torch on the CPU, read back
  as f64 NumPy); ``P`` moves along ``N`` and normals are rebuilt from
  the displaced mesh (area-weighted).
- **Atmosphere / volume** (``RiAtmosphere``): run per eye ray over (Ci,
  ray length) inside the tile, in torch on the tile's device.
  `Atmosphere` holds a stage's constants on that device, built once a
  Renderer (miefog's phase table is an f64 host build; an .sl shader is
  compiled and its parameters bound), so a tile copies nothing from the
  host; `apply_atmosphere` is lucille_tpu's signature.
- **Imager** (``RiImager``): run once over the assembled frame (Ci,
  alpha per pixel): the built-ins in NumPy on the host, as lucille_tpu's
  are, an .sl shader in torch on the Renderer's device.

The built-ins are lucille_tpu's: the MOSAIC Blender-export shaders and
the RenderMan standard fog, depthcue and background (the semantics of
the .sl sources shipped with examples/plane_sphere/Shaders), and
miefog.  A stage naming anything else runs ``<name>.sl`` from the
option's search path, compiled by shading/sl.py (`sl.find_sl`): a
source of another kind warns once and is used anyway; a source that
does not compile, or none found, warns once and the stage is ignored,
as in lucille_tpu.  Compiled stages are cached in the dict their caller
passes (a Renderer's, by (name, kind), which also holds its surfaces),
not process-wide as lucille_tpu's `_compiled` is, which ignores the
search path.  A stage whose output is uniform is broadcast over its
lanes (lucille_tpu's reshape refuses it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lucille_tpu_torch.base.log import LOG_INFO, LOG_WARN, log, log_once
from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.imageio.loader import find_file, load_image
from lucille_tpu_torch.lights.envmap import _np_bilinear
from lucille_tpu_torch.shading.shader import ShaderContext, ShaderGlobals
from lucille_tpu_torch.shading.sl import find_sl

IMAGERS = ("background", "MOSAICbackground")
ATMOSPHERES = ("miefog", "fog", "depthcue", "MOSAICfog")
DISPLACEMENTS = ("MOSAICdisplace",)


def _p1(params: dict, name: str, default):
    """Scalar/array parameter lookup tolerant of inline declarations."""
    for key, val in params.items():
        if key.split()[-1] == name:
            arr = np.asarray(val, dtype=np.float64).reshape(-1)
            return arr if np.ndim(default) else float(arr[0])
    return default


def _pstr(params: dict, name: str, default: str = "") -> str:
    for key, val in params.items():
        if key.split()[-1] == name:
            return str(val[0] if isinstance(val, (list, tuple, np.ndarray)) else val)
    return default


# ---------------------------------------------------------------------------
# imager stage (film post-pass)
# ---------------------------------------------------------------------------


def apply_imager(frame, alpha, name, params, searchpaths=None,
                 device="cpu", compiled=None):
    """frame: (H, W, 3) f32; alpha: (H, W) f32 coverage, NumPy on the
    host.  Returns the post-processed (H, W, 3) frame; an .sl imager
    runs on `device`, compiled into `compiled` (module docstring)."""
    if not name:
        return frame
    if name in IMAGERS:
        # Ci += (1 - alpha) * bgcolor; alpha = 1
        # (examples/plane_sphere/Shaders/MOSAICbackground.sl semantics)
        bg = np.asarray(_p1(params, "bgcolor", np.ones(3)), np.float32)[:3]
        return frame + (1.0 - alpha)[..., None] * bg
    fn = find_sl(name, "imager", searchpaths, compiled)
    if fn is None:
        return frame
    dev = torch.device(device)
    H, W = frame.shape[:2]
    ci = torch.from_numpy(np.ascontiguousarray(frame, np.float32)).to(dev)
    sg, ctx = _flat_globals(ci.reshape(-1, 3), W, H)
    a = torch.from_numpy(np.ascontiguousarray(alpha, np.float32)).to(dev)
    out = fn.run_vars(sg, dict(params), ctx,
                      extra_globals={"alpha": a.reshape(-1),
                                     "Ci": ci.reshape(-1, 3)})
    return torch.broadcast_to(out["Ci"], (H * W, 3)).reshape(
        frame.shape).cpu().numpy()


# ---------------------------------------------------------------------------
# atmosphere / volume stage (per eye ray)
# ---------------------------------------------------------------------------


class Atmosphere:
    """One atmosphere stage with its constants on `device`:
    atm(ci, ray_len, P, hit, dirn) fogs the wavefront radiance ci (B, 3)
    by the eye rays' lengths ray_len (B,), at hit points P (B, 3) along
    directions dirn (B, 3); escaped rays (hit False) keep their radiance.
    A stage that is not built in runs its .sl, compiled into `compiled`
    and bound here, or is ignored (module docstring)."""

    def __init__(self, name, params, searchpaths, device, compiled=None):
        self.name = name
        self.params = dict(params)
        self.fn = None  # an .sl volume shader
        dev = torch.device(device)
        p = self.params
        if name == "miefog":
            # single-scattering haze with a Lorenz-Mie phase function
            # (ops/mie.py): Beer-Lambert extinction over the eye path
            # plus in-scatter from a directional sun, the phase at the
            # eye ray / sun angle
            from lucille_tpu_torch.ops.mie import phase_table

            self.density = max(_p1(p, "density", 0.05), 0.0)
            self.albedo = min(max(float(_p1(p, "albedo", 0.9)), 0.0), 1.0)
            sundir = np.asarray(
                _p1(p, "sundir", np.array([0.3, 1.0, 0.2])), np.float32
            )[:3]
            sundir = sundir / max(np.linalg.norm(sundir), 1e-9)
            suncol = np.asarray(
                _p1(p, "suncolor", np.ones(3)), np.float32
            )[:3] * _p1(p, "intensity", 1.0)
            self.sundir = const_vec(sundir, dev)
            self.suncol = const_vec(suncol, dev)
            table = phase_table(_p1(p, "wavelength", 600.0),      # nm
                                _p1(p, "particlesize", 1000.0),   # nm
                                _p1(p, "eta", 1.33), 1.0)         # water
            self.table = torch.from_numpy(table.astype(np.float32)).to(dev)
        elif name in ("fog", "depthcue"):
            self.bg = const_vec(np.asarray(
                _p1(p, "background", np.zeros(3)), np.float32)[:3], dev)
        elif name == "MOSAICfog":
            self.mistcol = const_vec(np.asarray(
                _p1(p, "MistCol", np.zeros(3)), np.float32)[:3], dev)
        else:
            self.fn = find_sl(name, "volume", searchpaths, compiled)
            if self.fn is not None:
                self.bound = self.fn.bind(self.params, dev)
                self.axes = torch.eye(3, device=dev)

    def __call__(self, ci, ray_len, P, hit, dirn):
        p = self.params
        if self.fn is not None:
            # the volume shader reads the ray vector I (its length the
            # ray's), along z as in lucille_tpu
            sg, ctx = _flat_globals(ci, ci.shape[0], 1, self.axes)
            out = self.fn.run_vars(sg, self.bound, ctx, extra_globals={
                "Ci": ci, "I": P * 0.0 + ray_len[:, None] * self.axes[2],
                "P": P})
            return torch.where(hit[:, None],
                               torch.broadcast_to(out["Ci"], ci.shape), ci)
        if self.name == "miefog":
            d = dirn / torch.clamp_min(torch.linalg.vector_norm(
                dirn, dim=-1, keepdim=True), 1e-20)
            cosg = d @ self.sundir
            res = self.table.shape[0]
            theta = torch.arccos(torch.clamp(cosg, -1.0, 1.0))
            f = theta / (2.0 * math.pi) * res
            i0 = torch.clamp(f.to(torch.int32), 0, res - 2).long()
            wfrac = f - i0.to(torch.float32)
            ph = self.table[i0] * (1.0 - wfrac) + self.table[i0 + 1] * wfrac
            ext = torch.exp(-self.density * ray_len)
            inscatter = (self.albedo * (1.0 - ext[:, None]) * ph[:, None]
                         * self.suncol[None, :])
            out = ci * ext[:, None] + inscatter
        elif self.name == "fog":
            # standard RenderMan fog: mix toward background on 1-exp(-l/d)
            dist = max(_p1(p, "distance", 1.0), 1e-6)
            f = 1.0 - torch.exp(-ray_len / dist)
            out = ci * (1.0 - f)[:, None] + f[:, None] * self.bg
        elif self.name == "depthcue":
            mind = _p1(p, "mindistance", 0.0)
            maxd = max(_p1(p, "maxdistance", 1.0), mind + 1e-6)
            f = torch.clamp((ray_len - mind) / (maxd - mind), 0.0, 1.0)
            out = ci * (1.0 - f)[:, None] + f[:, None] * self.bg
        elif self.name == "MOSAICfog":
            # examples/plane_sphere/Shaders/MOSAICfog.sl semantics (Blender
            # mist); defaults (isMist=0) are a no-op, matching the export
            if _p1(p, "isMist", 0.0) <= 0:
                return ci
            sta = _p1(p, "Sta", 0.0)
            di = _p1(p, "Di", 0.0)
            if sta >= di:
                return ci
            hi = _p1(p, "Hi", 0.0)
            misi = _p1(p, "Misi", 0.0)
            mtype = int(_p1(p, "MistType", 0.0))
            li = ray_len - sta
            dl = di - sta
            if mtype == 0:
                dl = dl / torch.clamp(li / dl, 1e-6, 1.0)
            elif mtype == 2:
                dl = (dl + li) / 2.0
            d = 1.0 - torch.clamp(li / dl, 0.0, 1.0)
            if hi > 0:
                # height falloff on the world height of the hit point
                hfrac = torch.clamp(P[:, 1] / hi, 0.0, 1.0)
                d = d * (1.0 - hfrac) + 1.0 * hfrac
            d = d * (1.0 - misi)
            out = self.mistcol[None, :] * (1.0 - d)[:, None] + ci * d[:, None]
        else:
            return ci
        return torch.where(hit[:, None], out, ci)


def apply_atmosphere(ci, ray_len, P, hit, name, params, searchpaths=None,
                     dirn=None):
    """Fog the wavefront radiance by ray length (lucille_tpu's signature;
    the Renderer builds its `Atmosphere` once instead).

    ci: (B, 3); ray_len: (B,) eye-ray |I|; P: (B, 3) hit points;
    hit: (B,) bool — escaped rays keep their radiance; dirn: (B, 3) eye
    directions (the "miefog" phase needs the eye/sun angle; without them
    miefog is not applied, as in lucille_tpu)."""
    if not name or (name == "miefog" and dirn is None):
        return ci
    return Atmosphere(name, params, searchpaths, ci.device)(
        ci, ray_len, P, hit, dirn)


# ---------------------------------------------------------------------------
# displacement stage (vertex-level, scene compile time)
# ---------------------------------------------------------------------------


def displace_scene(desc, compiled=None) -> None:
    """Run bound displacement shaders over their geometries' vertices,
    in place, then rebuild vertex normals from the displaced mesh.
    Called once before scene compilation; .sl shaders are compiled into
    `compiled` (module docstring)."""
    for g in desc.geoms:
        name = getattr(g.attrs, "displacement", None)
        if not name or getattr(g, "_displaced", False):
            continue  # idempotent: a second Renderer must not re-displace
        params = g.attrs.displacement_params
        if _displace_geom(g, name, params, desc.options.searchpaths,
                          compiled):
            g._displaced = True
            log(LOG_INFO, "displaced '%s' over %d vertices", name,
                len(g.positions))


def _vertex_normals(P: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (geom.c ri_geom_calc_normals
    capability)."""
    fn = np.cross(P[idx[:, 1]] - P[idx[:, 0]], P[idx[:, 2]] - P[idx[:, 0]])
    vn = np.zeros_like(P)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    n = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(n, 1e-20)


def _displace_geom(g, name, params, searchpaths, compiled=None) -> bool:
    P = np.asarray(g.positions, dtype=np.float64)
    idx = np.asarray(g.indices)
    N = g.normals
    if N is None or len(N) != len(P):
        N = _vertex_normals(P, idx)
    N = np.asarray(N, dtype=np.float64)
    st = g.st if getattr(g, "st", None) is not None else None
    s = st[:, 0] if st is not None else np.zeros(len(P))
    t = st[:, 1] if st is not None else np.zeros(len(P))

    if name in DISPLACEMENTS:
        # examples/plane_sphere/Shaders/MOSAICdisplace.sl: displacement
        # map moves P along N by Disp * (tex - Mid); empty DispMap = no-op
        dispmap = _pstr(params, "DispMap", "")
        if not dispmap:
            return False
        found = find_file(dispmap, searchpaths)
        if found is None:
            log_once(LOG_WARN, f"DispMap '{dispmap}' not found; skipping")
            return False
        img = np.asarray(load_image(found), np.float64)
        disp = _p1(params, "Disp", 1.0)
        mid = _p1(params, "Mid", 0.5)
        amp = disp * (_np_bilinear(img, s, t)[..., 0] - mid)
        P = P + amp[:, None] * N
    else:
        fn = find_sl(name, "displacement", searchpaths, compiled)
        if fn is None:
            return False
        sg, ctx = _flat_globals(torch.zeros((len(P), 3)), len(P), 1)
        sg.P = torch.from_numpy(P.astype(np.float32))
        sg.N = torch.from_numpy(N.astype(np.float32))
        sg.Ng = sg.N
        sg.s = torch.from_numpy(np.asarray(s, np.float32))
        sg.t = torch.from_numpy(np.asarray(t, np.float32))
        out = fn.run_vars(sg, dict(params), ctx)
        P = np.broadcast_to(np.asarray(out["P"], dtype=np.float64),
                            P.shape).copy()

    g.positions = P
    g.normals = _vertex_normals(P, idx)
    return True


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------


def _flat_globals(ci_flat, w, h, axes=None):
    """The globals and context of a stage that is not a surface: B =
    ci_flat's rows on its device, P = (x / w, y / h, 0) of lane
    B = y w + x, N = Ng = +z, dPdu = +x, dPdv = +y, I = E = 0, Cs =
    ci_flat, no scene.  axes: torch.eye(3) on that device, if the caller
    holds one (filled there: nothing is copied)."""
    dev = ci_flat.device
    B = ci_flat.shape[0]
    if axes is None:
        axes = torch.eye(3, device=dev)
    z = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    zs = torch.zeros((B,), dtype=torch.float32, device=dev)
    lane = torch.arange(B, dtype=torch.float32, device=dev)
    xy = torch.stack([torch.remainder(lane, w) / max(w, 1),
                      torch.div(lane, w, rounding_mode="floor") / max(h, 1)],
                     dim=-1)
    sg = ShaderGlobals(
        P=torch.cat([xy, zs[:, None]], dim=-1), N=z + axes[2],
        Ng=z + axes[2], I=z, E=z, Cs=ci_flat.to(torch.float32),
        Os=torch.ones((B, 3), dtype=torch.float32, device=dev),
        s=xy[:, 0], t=xy[:, 1], u=zs, v=zs, dPdu=z + axes[0],
        dPdv=z + axes[1])
    return sg, ShaderContext(scene=None, key=None)
