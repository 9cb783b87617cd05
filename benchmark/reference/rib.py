"""A reader for the RIB subset the benchmark's scenes use, in NumPy.

It knows Format, PixelSamples, Projection "perspective" "fov",
Orientation, Transform, ConcatTransform, WorldBegin/End,
AttributeBegin/End, PointsPolygons with "P" (triangles and quads, the
fixed corner orders (0, 1, 2) and (0, 1, 2) + (0, 2, 3)) and
AreaLightSource "sunsky" (its model's parameters); Display, Shutter and comments
are read past.  Text without WorldBegin is a camera: the transform it
ends with is the camera's.  Anything else raises: the reference renders only scenes
it reads whole.

Conventions are RenderMan's as lucille reads them: row vectors,
matrices row-major as the RIB writes them, ConcatTransform applied
before the current transform, WorldBegin saving the camera transform and
starting the world at identity, and under Orientation "rh" every vertex
mirrored in z (its object matrix times diag(1, 1, -1)).  Vertices are
transformed in float64 and stored in float32.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')


def _tokens(text: str):
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        yield from _TOKEN.findall(line)


def _number_list(toks, i):
    """The bracketed numbers at toks[i] ('[' ... ']') or one number."""
    if toks[i] != "[":
        return [float(toks[i])], i + 1
    j = toks.index("]", i)
    return [float(t) for t in toks[i + 1 : j]], j + 1


@dataclass
class RibScene:
    """What the reader found: the frame's settings, the camera and the
    world-space triangles (a, b, c each (N, 3) float32)."""

    width: int = 640
    height: int = 480
    pixel_samples: tuple = (1, 1)
    fov: float = 90.0
    rh: bool = False
    world_to_camera: np.ndarray = field(default_factory=lambda: np.eye(4))
    tris: list = field(default_factory=list)  # [(a, b, c)] per PointsPolygons
    sunsky: dict | None = None  # the sunsky light's model parameters

    def triangles(self):
        """The world's triangles, each corner (N, 3) float32."""
        if not self.tris:
            z = np.zeros((0, 3), np.float32)
            return z, z, z
        return tuple(np.concatenate([t[k] for t in self.tris])
                     for k in range(3))


def points_polygons(scene: RibScene, nverts, indices, P, ctm):
    """Triangulate one PointsPolygons call into scene.tris."""
    om = ctm @ np.diag([1.0, 1.0, -1.0 if scene.rh else 1.0, 1.0])
    P = np.asarray(P, np.float64).reshape(-1, 3)
    world = P @ om[:3, :3] + om[3, :3]
    corners = []
    off = 0
    for nv in np.asarray(nverts, np.int64):
        face = np.asarray(indices[off : off + nv], np.int64)
        if nv == 3:
            corners.append(face[[0, 1, 2]])
        elif nv == 4:
            corners.append(face[[0, 1, 2]])
            corners.append(face[[0, 2, 3]])
        elif nv > 4:
            raise ValueError("PointsPolygons: faces of more than 4 vertices")
        off += nv
    idx = np.asarray(corners, np.int64).reshape(-1, 3)
    w32 = world.astype(np.float32)
    scene.tris.append((w32[idx[:, 0]], w32[idx[:, 1]], w32[idx[:, 2]]))


def sunsky_params(params: dict) -> dict:
    """AreaLightSource "sunsky"'s tokens as the sky model's keywords
    (lucille's lightsource.c:304-317): the RIB's standard_meridian is a
    time zone, 15 degrees an hour."""
    kw = {}
    for name, vals in params.items():
        if name in ("latitude", "longitude", "turbidity", "month", "day",
                    "hour", "julian_day"):
            kw[name] = vals[0]
        elif name == "time_of_day":
            kw["hour"] = vals[0]
        elif name == "standard_meridian":
            kw["standard_meridian"] = vals[0] * 15.0
    return kw


def read_rib(text: str) -> RibScene:
    toks = list(_tokens(text))
    scene = RibScene()
    ctm = [np.eye(4)]
    world = False
    i = 0
    while i < len(toks):
        op = toks[i]
        i += 1
        if op == "Format":
            scene.width, scene.height = int(toks[i]), int(toks[i + 1])
            i += 3
        elif op == "PixelSamples":
            scene.pixel_samples = (int(float(toks[i])), int(float(toks[i + 1])))
            i += 2
        elif op == "Projection":
            if toks[i] != '"perspective"':
                raise ValueError(f"Projection {toks[i]}: only perspective")
            i += 1
            while i < len(toks) and toks[i].startswith('"'):
                name = toks[i].strip('"').split()[-1]
                vals, i = _number_list(toks, i + 1)
                if name == "fov":
                    scene.fov = vals[0]
        elif op == "Orientation":
            scene.rh = toks[i].strip('"') == "rh"
            i += 1
        elif op in ("Transform", "ConcatTransform"):
            vals, i = _number_list(toks, i)
            m = np.asarray(vals, np.float64).reshape(4, 4)
            ctm[-1] = m if op == "Transform" else m @ ctm[-1]
        elif op == "WorldBegin":
            scene.world_to_camera = ctm[-1].copy()
            ctm.append(np.eye(4))
            world = True
        elif op == "AttributeBegin":
            ctm.append(ctm[-1].copy())
        elif op in ("AttributeEnd", "WorldEnd"):
            ctm.pop()
        elif op == "PointsPolygons":
            nverts, i = _number_list(toks, i)
            indices, i = _number_list(toks, i)
            params = {}
            while i < len(toks) and toks[i].startswith('"'):
                name = toks[i].strip('"').split()[-1]
                params[name], i = _number_list(toks, i + 1)
            points_polygons(scene, [int(v) for v in nverts],
                            [int(v) for v in indices], params["P"], ctm[-1])
        elif op == "AreaLightSource":
            name = toks[i].strip('"')
            i += 2  # name, handle
            params = {}
            while i < len(toks) and toks[i].startswith('"'):
                params[toks[i].strip('"').split()[-1]], i = _number_list(
                    toks, i + 1)
            if name != "sunsky":
                raise ValueError(f"AreaLightSource {name}: only sunsky")
            scene.sunsky = sunsky_params(params)
        elif op == "Display":
            i += 3
        elif op == "Shutter":
            i += 2
        else:
            raise ValueError(f"RIB request {op!r} is outside the subset")
    if not world:  # a camera alone: its transform so far
        scene.world_to_camera = ctm[-1].copy()
    return scene
