"""Polygon → triangle conversion.

Equivalent capability to the reference polygon geometry driver
(src/render/polygon.c): ``Polygon``, ``PointsPolygons`` and
``PointsGeneralPolygons`` parameter lists ("P", "N", "st", "Cs" and
facevarying variants) become triangulated world-space geometry.

Semantics preserved from the reference (including its asymmetry):

- vertices are transformed by ``om = CTM @ orientation`` where orientation
  flips z for RH scenes (polygon.c:84-94); normals by the inverse-transpose
  (polygon.c:183).
- ``Polygon`` is fan-triangulated with winding reversed for RH scenes
  (ri_polygon_parse, polygon.c:348-367).
- ``PointsPolygons`` uses the FIXED corner orders (0,1,2) for triangles and
  (0,1,2)+(0,2,3) for quads with NO orientation-dependent reversal, and
  faces with more than 4 vertices are skipped with a one-time warning
  (ri_pointspolygons_parse, polygon.c:534-590) — this asymmetry is what
  makes the bundled AO scene's ground plane face up.
- two-sided geometry (Sides 2) duplicates faces with reversed winding
  (polygon.c:368-381, 596-619).
- malformed input (index shortage, zero polygons — the ribparse regression
  scenes) is skipped with a warning instead of crashing.

The port's copy of lucille_tpu/ri/polygon.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import numpy as np

from lucille_tpu_torch.base.log import LOG_WARN, log
from lucille_tpu_torch.ops import vecmat as vm
from lucille_tpu_torch.ri.types import AttributeState, GeomData


def _orientation_matrix(rh: bool) -> np.ndarray:
    m = vm.mat4_identity()
    if rh:
        m[2, 2] = -1.0
    return m


def _fan_indices(nverts: int, rh: bool) -> np.ndarray:
    """Triangle-fan indices for one face (polygon.c:356-367)."""
    j = np.arange(nverts - 2)
    if rh:
        tri = np.stack([j + 2, j + 1, np.zeros_like(j)], axis=-1)
    else:
        tri = np.stack([np.zeros_like(j), j + 1, j + 2], axis=-1)
    return tri.astype(np.int64)


def _param_array(params: dict, *names, width: int):
    for nm in names:
        if nm in params:
            arr = np.asarray(params[nm], dtype=np.float64)
            return arr.reshape(-1, width)
    return None


def _find_param(params: dict, base: str):
    """Look up a parameter by its BASE name, tolerating inline
    declarations ('facevertex float s' — examples/texparam/st1.rib).
    Returns (flat float array, storage class string) or (None, '')."""
    for k, v in params.items():
        parts = str(k).split()
        if parts and parts[-1] == base:
            cls = " ".join(parts[:-1])
            try:
                return np.asarray(v, dtype=np.float64).reshape(-1), cls
            except (ValueError, TypeError):
                return None, ""
    return None, ""


def _gather_st(params: dict, npoints: int, nfaceverts: int):
    """Collect texture coordinates from 'st' or separate 's'/'t' params.

    Returns (st_vertex (V, 2) | None, st_facevarying (F*, 2) | None) where
    facevarying values are ordered per face-vertex (reference
    texcoords_unshared, intersection_state.c:222-230)."""
    st, st_cls = _find_param(params, "st")
    if st is not None:
        st = st.reshape(-1, 2)
        if len(st) == npoints and "facev" not in st_cls:
            return st, None
        if len(st) == nfaceverts:
            return None, st
        return (st, None) if len(st) == npoints else (None, None)
    s, s_cls = _find_param(params, "s")
    t, t_cls = _find_param(params, "t")
    if s is None or t is None or len(s) != len(t):
        return None, None
    st = np.stack([s, t], axis=-1)
    facev = "facev" in s_cls or "facev" in t_cls
    if facev and len(st) == nfaceverts:
        return None, st
    if len(st) == npoints:
        return st, None
    if len(st) == nfaceverts:
        return None, st
    return None, None


def build_polygon(
    params: dict,
    ctm: np.ndarray,
    rh: bool,
    attrs: AttributeState,
) -> GeomData | None:
    """RiPolygon: one convex polygon, nverts implied by len(P).

    Uses the RH-reversed triangle fan of ri_polygon_parse
    (polygon.c:348-367), unlike PointsPolygons (see module docstring).
    """
    P = _param_array(params, "P", width=3)
    if P is None or len(P) < 3:
        log(LOG_WARN, "Polygon with no/insufficient \"P\"; skipping")
        return None
    nverts = len(P)
    return build_points_polygons(
        {"P": P.reshape(-1), **{k: v for k, v in params.items() if k != "P"}},
        [nverts],
        list(range(nverts)),
        ctm,
        rh,
        attrs,
        winding="rh_fan",
    )


def build_points_polygons(
    params: dict,
    nvertices: list,
    indices: list,
    ctm: np.ndarray,
    rh: bool,
    attrs: AttributeState,
    winding: str = "fixed",
) -> GeomData | None:
    """RiPointsPolygons → GeomData (world-space, triangulated).

    winding="fixed": reference ri_pointspolygons_parse — (0,1,2) for
    triangles, (0,1,2)+(0,2,3) for quads, faces >4 verts skipped.
    winding="rh_fan": reference ri_polygon_parse — general fan, reversed
    for RH scenes (used by RiPolygon and the subdivision tessellator).
    """
    P = _param_array(params, "P", width=3)
    if P is None:
        log(LOG_WARN, "PointsPolygons without \"P\"; skipping")
        return None
    nvertices = np.asarray(nvertices, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if nvertices.size == 0:
        # zero_poly_20081209.rib: empty geometry is legal and renders nothing
        return None
    if indices.size < int(nvertices.sum()):
        log(
            LOG_WARN,
            "PointsPolygons index shortage (%d indices for %d vertices); skipping",
            indices.size,
            int(nvertices.sum()),
        )
        return None
    if indices.size and int(indices.max()) >= len(P):
        log(
            LOG_WARN,
            "PointsPolygons vertex index %d out of range (%d points); skipping",
            int(indices.max()),
            len(P),
        )
        return None

    om = vm.mat4_mul(ctm, _orientation_matrix(rh))
    positions = vm.transform_point(P, om)

    N = _param_array(params, "N", width=3)
    normals = None
    if N is not None and len(N) == len(P):
        normals = vm.normalize(vm.transform_normal(N, om))

    st_vtx, st_fv = _gather_st(params, len(P), int(nvertices.sum()))

    Cs = _param_array(params, "Cs", width=3)
    colors = Cs if Cs is not None and len(Cs) == len(P) else None

    two_sided = attrs.sides == 2

    tri_list = []
    tri_st = [] if st_fv is not None else None
    offset = 0
    warned_ngon = False
    _FIXED = {
        3: np.array([[0, 1, 2]], dtype=np.int64),
        4: np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64),
    }
    for nv in nvertices:
        nv = int(nv)
        if nv < 3:
            offset += nv
            continue
        if winding == "fixed":
            fan = _FIXED.get(nv)
            if fan is None:
                # >4-gon: skipped (polygon.c:559-563), warn once
                if not warned_ngon:
                    log(
                        LOG_WARN,
                        "PointsPolygons supports only triangle or quad faces; skipping %d-gon",
                        nv,
                    )
                    warned_ngon = True
                offset += nv
                continue
        else:
            fan = _fan_indices(nv, rh)
        face_idx = indices[offset : offset + nv]
        tri_list.append(face_idx[fan])
        if tri_st is not None and offset + nv <= len(st_fv):
            face_st = st_fv[offset : offset + nv]
            tri_st.append(face_st[fan])
        offset += nv

    if not tri_list:
        return None
    tris = np.concatenate(tri_list, axis=0)

    if two_sided:
        tris = np.concatenate([tris, tris[:, ::-1]], axis=0)
        if tri_st is not None:
            tri_st = tri_st + [s[:, ::-1] for s in tri_st]

    geom = GeomData(
        positions=positions,
        indices=tris.astype(np.int32),
        normals=normals,
        st=st_vtx,
        colors=colors,
        attrs=attrs.copy(),
        kind="polygon",
    )
    if tri_st is not None and tri_st:
        geom.st = None
        geom.facevarying_st = np.concatenate(tri_st, axis=0)  # (F, 3, 2)
    return geom


def build_points_general_polygons(
    params: dict,
    nloops: list,
    nvertices: list,
    indices: list,
    ctm: np.ndarray,
    rh: bool,
    attrs: AttributeState,
) -> GeomData | None:
    """RiPointsGeneralPolygons; like the reference, only single-loop
    (hole-free) faces are supported (polygon.c PointsGeneralPolygons path)."""
    nloops = np.asarray(nloops, dtype=np.int64)
    if (nloops > 1).any():
        log(LOG_WARN, "PointsGeneralPolygons with holes unsupported; using outer loops only")
    return build_points_polygons(params, nvertices, indices, ctm, rh, attrs)
