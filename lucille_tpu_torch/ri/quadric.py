"""Quadric tessellation: RiSphere.

Equivalent capability to the reference's src/ri/quadric.c (ri_api_sphere,
quadric.c:24-54): a 16x16 tessellated triangle sphere with poles, clipped
to [zmin, zmax] via latitude limits, transformed by the CTM.

Quirk preserved: the reference transforms sphere vertices by the CTM only
— WITHOUT the RH orientation z-flip that polygon.c applies (quadric.c uses
`m`, not `om`); we match that exactly so mixed scenes land where the
reference puts them.

The port's copy of lucille_tpu/ri/quadric.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import math

import numpy as np

from lucille_tpu_torch.ops import vecmat as vm
from lucille_tpu_torch.ri.types import AttributeState, GeomData

NDIV = 16  # reference quadric.c:27 ("TODO: Adaptive tessellation")


def build_sphere(
    radius: float,
    zmin: float,
    zmax: float,
    thetamax: float,
    ctm: np.ndarray,
    rh: bool,
    attrs: AttributeState,
) -> GeomData:
    del rh  # reference quadric.c does not apply the orientation flip
    ndiv = NDIV
    phimin = math.asin(zmin / radius) if zmin > -radius else -0.5 * math.pi
    phimax = math.asin(zmax / radius) if zmax < radius else 0.5 * math.pi
    theta_max = math.radians(thetamax)

    # ndiv*(ndiv-1) ring vertices + 2 poles (quadric.c:60)
    verts = np.zeros((ndiv * (ndiv - 1) + 2, 3), dtype=np.float64)
    verts[0] = (0.0, 0.0, -radius)  # south pole
    verts[-1] = (0.0, 0.0, radius)  # north pole
    vi = 1
    for v in range(1, ndiv):
        phi = phimin + (phimax - phimin) * (v / ndiv)
        for u in range(ndiv):
            th = theta_max * (u / ndiv)
            verts[vi] = (
                radius * math.cos(phi) * math.cos(th),
                radius * math.cos(phi) * math.sin(th),
                radius * math.sin(phi),
            )
            vi += 1

    tris = []
    # south cap: pole to first ring
    for u in range(ndiv):
        u2 = (u + 1) % ndiv
        tris.append((0, 1 + u2, 1 + u))
    # bands
    for v in range(ndiv - 2):
        base0 = 1 + v * ndiv
        base1 = 1 + (v + 1) * ndiv
        for u in range(ndiv):
            u2 = (u + 1) % ndiv
            tris.append((base0 + u, base0 + u2, base1 + u2))
            tris.append((base0 + u, base1 + u2, base1 + u))
    # north cap
    npole = len(verts) - 1
    basen = 1 + (ndiv - 2) * ndiv
    for u in range(ndiv):
        u2 = (u + 1) % ndiv
        tris.append((npole, basen + u, basen + u2))

    positions = vm.transform_point(verts, ctm)
    # object-space normals are just the (unit) positions; world normals via
    # inverse-transpose (quadric.c itm construction strips translation).
    normals = vm.normalize(vm.transform_normal(verts / radius, ctm))

    return GeomData(
        positions=positions,
        indices=np.asarray(tris, dtype=np.int32),
        normals=normals,
        attrs=attrs.copy(),
        kind="sphere",
    )
