"""Device light tables.

Flattens the scene's LightDesc list (reference ri_light_t, light.h:34-62)
into small constant arrays plus static per-light metadata.  Light count is
tiny and static, so integrators unroll a Python loop over lights — each
light type's sampling code specializes at trace time (no dynamic dispatch
on device).

The port's copy of lucille_tpu/lights/tables.py: the same code, except
that a dome or IBL light with an environment texture raises (`_load_env`:
the port has no environment maps yet), and that an area light carries its
sampling tables on the render device (`LightEntry.area`), built with the
tables, once, where lucille_tpu uploads them at trace time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

LIGHT_DISTANT = "distant"
LIGHT_SUN = "sun"
LIGHT_POINT = "point"
LIGHT_DOME = "dome"
LIGHT_AREA = "area"
LIGHT_IBL = "ibl"
LIGHT_SUNSKY = "sunsky"


@dataclass(frozen=True)
class LightEntry:
    """Static per-light record; array-valued fields upload at trace time."""

    type: str
    position: tuple
    direction: tuple
    color: tuple
    intensity: float
    # area lights carry their OWN copy of the emitter triangles (the BVH
    # permutes the scene arrays, so scene indices would go stale):
    # dict(v0, e1, e2, area_cdf, total_area) of numpy arrays, or None
    tris: Any = None
    # IBL/sunsky: env map + sampler selection (light.h:44-53)
    texture_id: int = -1
    ibl_sampler: str = "cosweight"
    sunsky: Any = None
    env: Any = None  # lights.envmap.EnvMap or None
    # area lights: (area_cdf, v0, e1, e2) of `tris` as tensors on the
    # render device, built once with the tables (lights/sampling.py reads
    # them inside the tiles, where a copy would make the host wait)
    area: Any = field(default=None, compare=False)

    def __hash__(self):  # static jit argument
        return hash((self.type, self.position, self.direction, self.color,
                     self.intensity, self.texture_id, self.ibl_sampler,
                     id(self.tris), id(self.sunsky), id(self.env)))


@dataclass
class LightTables:
    lights: list = field(default_factory=list)  # list[LightEntry]

    @property
    def nlights(self) -> int:
        return len(self.lights)

    def __iter__(self):
        return iter(self.lights)


def _load_env(li, desc):
    """A dome/IBL light's environment texture (lucille_tpu's _load_env,
    lightsource.c:127-142).  The port has no environment maps yet
    (lucille_tpu/lights/envmap.py, ROADMAP Queue 1): such a light is
    refused (render/renderer.unsupported_features names it first), and
    every other light has none."""
    if li.type not in (LIGHT_DOME, LIGHT_IBL) or not li.texture:
        return None
    raise NotImplementedError(
        f"{li.type} light texture {li.texture!r}: environment maps are not "
        "ported yet (ROADMAP Queue 1)")


def build_light_tables(desc, scene=None, device="cpu") -> LightTables:
    """SceneDescription.lights -> LightTables, an area light's sampling
    tables on `device`.

    When no light exists, a default dome light is created — matching the
    reference's fallback (render.c:516-536, "There is no light. create
    domelight.").
    """
    entries = []
    for li in desc.lights:
        tris = area = None
        if li.geom_index >= 0 and li.geom_index < len(desc.geoms):
            g = desc.geoms[li.geom_index]
            if g.ntriangles > 0:
                P = g.positions
                idx = g.indices
                v0 = P[idx[:, 0]].astype(np.float32)
                e1 = (P[idx[:, 1]] - P[idx[:, 0]]).astype(np.float32)
                e2 = (P[idx[:, 2]] - P[idx[:, 0]]).astype(np.float32)
                area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
                total = float(area.sum())
                cdf = np.cumsum(area) / max(total, 1e-20)
                tris = dict(
                    v0=v0, e1=e1, e2=e2,
                    area_cdf=cdf.astype(np.float32),
                    total_area=total,
                )
                area = tuple(torch.from_numpy(tris[k]).to(device)
                             for k in ("area_cdf", "v0", "e1", "e2"))
        entries.append(
            LightEntry(
                type=li.type,
                position=tuple(np.asarray(li.position, dtype=float)),
                direction=tuple(np.asarray(li.direction, dtype=float)),
                color=tuple(np.asarray(li.color, dtype=float)),
                intensity=float(li.intensity),
                tris=tris,
                ibl_sampler=li.ibl_sampler,
                sunsky=li.sunsky,
                env=_load_env(li, desc),
                area=area,
            )
        )
    if not entries:
        entries.append(
            LightEntry(
                type=LIGHT_DOME,
                position=(0.0, 0.0, 0.0),
                direction=(0.0, -1.0, 0.0),
                color=(1.0, 1.0, 1.0),
                intensity=1.0,
            )
        )
    return LightTables(entries)


