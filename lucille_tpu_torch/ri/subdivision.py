"""Catmull-Clark subdivision surfaces.

Equivalent capability to the reference's src/ri/subdivision.c +
src/render/subdivision.c: ``RiSubdivisionMesh "catmull-clark"`` control
cages are refined MAXSUBDIVLEVEL-1 = 3 times (subdivision.h:18,
ri/subdivision.c:105-116) and the limit-ish mesh is triangulated like any
other polygon mesh.

The refinement itself is a clean vectorized NumPy implementation of the
classic Catmull-Clark rules (face points, edge points, repositioned
vertex points) rather than the reference's linked-list mesh walker.

The port's copy of lucille_tpu/ri/subdivision.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import numpy as np

from lucille_tpu_torch.base.log import LOG_WARN, log
from lucille_tpu_torch.ri.polygon import build_points_polygons
from lucille_tpu_torch.ri.types import AttributeState, GeomData

MAX_SUBDIV_LEVEL = 4  # reference subdivision.h:18
SUBDIV_STEPS = MAX_SUBDIV_LEVEL - 1  # ri/subdivision.c:116


def catmull_clark(points: np.ndarray, faces: list) -> tuple:
    """One Catmull-Clark step.

    points: (V, 3); faces: list of index lists (any arity >= 3).
    Returns (new_points, new_faces) where every new face is a quad.
    """
    V = len(points)
    nf = len(faces)

    # 1. face points: centroid of each face
    face_pts = np.array([points[np.asarray(f)].mean(axis=0) for f in faces])

    # edge bookkeeping: edge key -> [edge index], adjacency
    edge_index: dict = {}
    edge_faces: list = []
    edge_verts: list = []
    for fi, f in enumerate(faces):
        n = len(f)
        for k in range(n):
            a, b = f[k], f[(k + 1) % n]
            key = (a, b) if a < b else (b, a)
            ei = edge_index.get(key)
            if ei is None:
                ei = len(edge_verts)
                edge_index[key] = ei
                edge_verts.append(key)
                edge_faces.append([])
            edge_faces[ei].append(fi)

    ne = len(edge_verts)
    edge_verts_arr = np.asarray(edge_verts)

    # 2. edge points: average of the two endpoints and the two adjacent
    # face points (boundary edges: midpoint).
    edge_pts = np.zeros((ne, 3))
    boundary = np.zeros(ne, dtype=bool)
    for ei in range(ne):
        a, b = edge_verts_arr[ei]
        fs = edge_faces[ei]
        if len(fs) == 2:
            edge_pts[ei] = (
                points[a] + points[b] + face_pts[fs[0]] + face_pts[fs[1]]
            ) / 4.0
        else:
            edge_pts[ei] = (points[a] + points[b]) / 2.0
            boundary[ei] = True

    # 3. vertex points: (F + 2R + (n-3)P) / n for interior vertices with
    # valence n, F = avg adjacent face points, R = avg adjacent edge
    # midpoints; boundary vertices use the crease rule (1/8, 3/4, 1/8).
    vert_face_sum = np.zeros((V, 3))
    vert_face_cnt = np.zeros(V)
    for fi, f in enumerate(faces):
        for vtx in f:
            vert_face_sum[vtx] += face_pts[fi]
            vert_face_cnt[vtx] += 1

    vert_edge_sum = np.zeros((V, 3))
    vert_edge_cnt = np.zeros(V)
    vert_bedge_sum = np.zeros((V, 3))
    vert_bedge_cnt = np.zeros(V)
    for ei in range(ne):
        a, b = edge_verts_arr[ei]
        mid = (points[a] + points[b]) / 2.0
        vert_edge_sum[a] += mid
        vert_edge_sum[b] += mid
        vert_edge_cnt[a] += 1
        vert_edge_cnt[b] += 1
        if boundary[ei]:
            vert_bedge_sum[a] += (points[a] + points[b]) / 2.0
            vert_bedge_sum[b] += (points[a] + points[b]) / 2.0
            vert_bedge_cnt[a] += 1
            vert_bedge_cnt[b] += 1

    new_vpts = points.copy()
    for vtx in range(V):
        n = vert_face_cnt[vtx]
        if vert_bedge_cnt[vtx] >= 2:
            # boundary/crease vertex
            new_vpts[vtx] = 0.75 * points[vtx] + 0.25 * (
                vert_bedge_sum[vtx] / vert_bedge_cnt[vtx]
            )
        elif n > 0 and vert_edge_cnt[vtx] > 0:
            F = vert_face_sum[vtx] / n
            R = vert_edge_sum[vtx] / vert_edge_cnt[vtx]
            new_vpts[vtx] = (F + 2.0 * R + (n - 3.0) * points[vtx]) / n

    # assemble: new points = [vertex points | face points | edge points]
    new_points = np.concatenate([new_vpts, face_pts, edge_pts], axis=0)
    fp_off = V
    ep_off = V + nf

    new_faces = []
    for fi, f in enumerate(faces):
        n = len(f)
        for k in range(n):
            a = f[k]
            e_prev = edge_index[tuple(sorted((f[(k - 1) % n], a)))]
            e_next = edge_index[tuple(sorted((a, f[(k + 1) % n])))]
            new_faces.append(
                [a, ep_off + e_next, fp_off + fi, ep_off + e_prev]
            )
    return new_points, new_faces


def build_subdivision_mesh(
    scheme: str,
    nvertices: list,
    vertices: list,
    params: dict,
    ctm: np.ndarray,
    rh: bool,
    attrs: AttributeState,
) -> GeomData | None:
    """RiSubdivisionMesh → refined, triangulated GeomData."""
    if scheme != "catmull-clark":
        log(LOG_WARN, "SubdivisionMesh scheme '%s' unsupported; skipping", scheme)
        return None
    P = np.asarray(params.get("P", []), dtype=np.float64).reshape(-1, 3)
    if len(P) == 0:
        return None
    faces = []
    off = 0
    vertices = list(np.asarray(vertices, dtype=np.int64))
    for nv in nvertices:
        nv = int(nv)
        faces.append([int(v) for v in vertices[off : off + nv]])
        off += nv

    pts = P
    for _ in range(SUBDIV_STEPS):
        pts, faces = catmull_clark(pts, faces)

    flat_idx = [v for f in faces for v in f]
    nverts = [len(f) for f in faces]
    geom = build_points_polygons(
        {"P": pts.reshape(-1)}, nverts, flat_idx, ctm, rh, attrs
    )
    if geom is not None:
        geom.kind = "subdiv"
    return geom
