"""Curve (hair/fur) primitive: Bezier strands tessellated to triangles.

Capability analog of the reference's FurRender R&D renderer
(/root/reference/rnd/FurRender/curve.{h,c}: 4-control-point Bezier
curves, Nakamaru & Ono "Ray Tracing for Curves Primitive", WSCG 2002).
The reference intersects each curve by recursive subdivision per ray —
per-ray data-dependent recursion, the wrong shape for a vector machine.
Here each strand is tessellated ONCE on the host into a thin tube of
triangles that ride the measured tile kernels (pallas_isect /
pallas_bvh), so a million hair segments get the same Mrays/s as any
other million triangles; the subdivision depth is a fixed sampling rate
instead of a per-ray tolerance loop.

Frames along the strand use rotation-minimizing double-reflection
(Wang et al., "Computation of Rotation Minimizing Frames", TOG 2008) so
tubes do not twist through inflection points the way Frenet frames do.

RIB surface: ``Curves "cubic"|"linear" [nvertices] "nonperiodic"
"P" [...] "width" [...]|"constantwidth" [w]`` (RiCurves).

The port's copy of lucille_tpu/ri/curves.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import numpy as np

from lucille_tpu_torch.ops import vecmat as vm
from lucille_tpu_torch.ri.types import AttributeState, GeomData

SAMPLES_PER_SEGMENT = 8  # curve-direction tessellation rate
TUBE_SIDES = 4           # cross-section sides (thin tubes: silhouette-true)


def bezier_eval(cp: np.ndarray, t: np.ndarray):
    """Cubic Bezier point + tangent at t (curve.c ri_bezier_curve_eval3
    semantics).  cp: (4, 3); t: (N,).  Returns ((N, 3), (N, 3))."""
    t = np.asarray(t, np.float64)[:, None]
    u = 1.0 - t
    p = (
        u * u * u * cp[0]
        + 3.0 * u * u * t * cp[1]
        + 3.0 * u * t * t * cp[2]
        + t * t * t * cp[3]
    )
    dp = (
        3.0 * u * u * (cp[1] - cp[0])
        + 6.0 * u * t * (cp[2] - cp[1])
        + 3.0 * t * t * (cp[3] - cp[2])
    )
    return p, dp


def _rmf(points: np.ndarray, tangents: np.ndarray) -> np.ndarray:
    """Rotation-minimizing frames by double reflection: (N, 3) normals
    perpendicular to the tangents, with minimal twist between samples."""
    n = len(points)
    t = tangents / np.maximum(
        np.linalg.norm(tangents, axis=-1, keepdims=True), 1e-12
    )
    # initial normal: any vector not parallel to t0
    a = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(a, t[0])) > 0.9:
        a = np.array([1.0, 0.0, 0.0])
    r = np.cross(t[0], a)
    r /= max(np.linalg.norm(r), 1e-12)
    out = np.zeros((n, 3))
    out[0] = r
    for i in range(n - 1):
        v1 = points[i + 1] - points[i]
        c1 = max(np.dot(v1, v1), 1e-20)
        rl = out[i] - (2.0 / c1) * np.dot(v1, out[i]) * v1
        tl = t[i] - (2.0 / c1) * np.dot(v1, t[i]) * v1
        v2 = t[i + 1] - tl
        c2 = max(np.dot(v2, v2), 1e-20)
        out[i + 1] = rl - (2.0 / c2) * np.dot(v2, rl) * v2
    return out


def _tube(points, tangents, radii):
    """Triangulate one strand's samples into a TUBE_SIDES-sided tube.
    Returns (verts (M, 3), normals (M, 3), tris (F, 3))."""
    n = len(points)
    t = tangents / np.maximum(
        np.linalg.norm(tangents, axis=-1, keepdims=True), 1e-12
    )
    r0 = _rmf(points, t)
    r1 = np.cross(t, r0)
    ang = 2.0 * np.pi * np.arange(TUBE_SIDES) / TUBE_SIDES
    ca, sa = np.cos(ang), np.sin(ang)
    # ring vertices: (n, TUBE_SIDES, 3)
    radial = (
        r0[:, None, :] * ca[None, :, None] + r1[:, None, :] * sa[None, :, None]
    )
    verts = points[:, None, :] + radial * radii[:, None, None]
    normals = radial
    i = np.arange(n - 1)[:, None]
    j = np.arange(TUBE_SIDES)[None, :]
    j1 = (j + 1) % TUBE_SIDES
    a = i * TUBE_SIDES + j
    b = i * TUBE_SIDES + j1
    c = (i + 1) * TUBE_SIDES + j
    d = (i + 1) * TUBE_SIDES + j1
    tris = np.concatenate(
        [
            np.stack([a, b, c], axis=-1).reshape(-1, 3),
            np.stack([b, d, c], axis=-1).reshape(-1, 3),
        ],
        axis=0,
    )
    return verts.reshape(-1, 3), normals.reshape(-1, 3), tris


def build_curves(
    degree: str,
    nvertices,
    wrap: str,
    params: dict,
    ctm: np.ndarray,
    rh: bool,
    attrs: AttributeState,
) -> GeomData | None:
    """RiCurves -> tessellated tube GeomData (world space)."""
    del rh  # tubes are orientation-symmetric
    P = np.asarray(params["P"], np.float64).reshape(-1, 3)
    nvertices = np.atleast_1d(np.asarray(nvertices, np.int64))
    widths = params.get("width")
    cwidth = float(
        np.atleast_1d(params.get("constantwidth", 0.01))[0]
    )
    if widths is not None:
        widths = np.asarray(widths, np.float64).reshape(-1)

    all_v, all_n, all_t = [], [], []
    voff = 0
    poff = 0
    woff = 0
    for nv in nvertices:
        nv = int(nv)
        cps = P[poff : poff + nv]
        poff += nv
        if degree == "linear":
            nseg = nv - 1
            ts = None
            pts = cps
            tans = np.gradient(cps, axis=0)
            nsamp = nv
        else:  # cubic Bezier, shared endpoints: step 3 (curve.h:20)
            nseg = max((nv - 1) // 3, 1)
            pts_l, tan_l = [], []
            for s in range(nseg):
                cp = cps[3 * s : 3 * s + 4]
                if len(cp) < 4:  # degenerate tail: pad with last point
                    cp = np.concatenate(
                        [cp, np.repeat(cp[-1:], 4 - len(cp), 0)]
                    )
                last = s == nseg - 1
                m = SAMPLES_PER_SEGMENT + (1 if last else 0)
                t = np.arange(m) / SAMPLES_PER_SEGMENT
                p, dp = bezier_eval(cp, t)
                pts_l.append(p)
                tan_l.append(dp)
            pts = np.concatenate(pts_l, axis=0)
            tans = np.concatenate(tan_l, axis=0)
            nsamp = len(pts)
        # widths: varying (one per original vertex, interpolated) or const
        if widths is not None and woff + nv <= len(widths):
            wv = widths[woff : woff + nv]
            radii = np.interp(
                np.linspace(0.0, 1.0, nsamp),
                np.linspace(0.0, 1.0, nv),
                wv,
            ) * 0.5
        else:
            radii = np.full(nsamp, cwidth * 0.5)
        woff += nv
        v, n, t3 = _tube(pts, tans, radii)
        all_t.append(t3 + voff)
        all_v.append(v)
        all_n.append(n)
        voff += len(v)

    if not all_v:
        return None
    verts = np.concatenate(all_v, axis=0)
    normals = np.concatenate(all_n, axis=0)
    tris = np.concatenate(all_t, axis=0)
    positions = vm.transform_point(verts, ctm)
    normals_w = vm.normalize(vm.transform_normal(normals, ctm))
    return GeomData(
        positions=positions,
        indices=tris.astype(np.int32),
        normals=normals_w,
        attrs=attrs.copy(),
        kind="curves",
    )
