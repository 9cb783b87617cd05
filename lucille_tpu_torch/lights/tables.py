"""Device light tables.

Flattens the scene's LightDesc list (reference ri_light_t, light.h:34-62)
into small constant arrays plus static per-light metadata.  Light count is
tiny and static, so integrators unroll a Python loop over lights — each
light type's sampling code specializes at trace time (no dynamic dispatch
on device).

The port's copy of lucille_tpu/lights/tables.py: the same code, except
that every device table is built once, on the render device, with the
tables (where lucille_tpu uploads at trace time): an area light's
sampling tables (`LightEntry.area`), and a dome or IBL light's
environment map with what its sampler reads (`EnvMap.prepare`).
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


def _load_env(li, desc, device):
    """Load a dome/IBL light's environment texture from the searchpaths
    into an EnvMap on `device` (light->texture, lightsource.c:127-142;
    fetched per gathered direction like ibl.c:53-540 / texture.c:238),
    binding any sisfile (light.h:51-52) and building what the light's
    sampler reads.  A map that is missing or cannot be read is logged and
    the light keeps its flat colour."""
    if li.type not in (LIGHT_DOME, LIGHT_IBL) or not li.texture:
        return None
    from lucille_tpu_torch.base.log import LOG_WARN, log
    from lucille_tpu_torch.imageio.loader import find_file, load_image
    from lucille_tpu_torch.lights.envmap import EnvMap

    sp = getattr(getattr(desc, "options", None), "searchpaths", None)
    found = find_file(li.texture, sp)
    if found is None:
        log(LOG_WARN, "IBL texture '%s' not found on searchpath; "
            "light falls back to flat color", li.texture)
        return None
    try:
        env = EnvMap(load_image(found), mapping=getattr(li, "mapping", None),
                     name=li.texture, device=device)
    except (ValueError, OSError) as e:
        log(LOG_WARN, "cannot load IBL texture '%s': %s", li.texture, e)
        return None
    if li.sis_file:
        sis = find_file(li.sis_file, sp)
        if sis is not None:
            env.load_sis(sis)
        else:
            log(LOG_WARN, "sisfile '%s' not found; generating SIS samples "
                "from the map", li.sis_file)
    return env.prepare(li.ibl_sampler or "cosweight")


def build_light_tables(desc, scene=None, *, device) -> LightTables:
    """SceneDescription.lights -> LightTables, an area light's sampling
    tables and an environment light's map on `device`.

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
                env=_load_env(li, desc, device),
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


