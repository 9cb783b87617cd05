"""Wavefront OBJ loader.

Equivalent capability to the reference testbed's OBJ loader
(src/testbed/glm.cpp, used by the interactive visual dev harness):
vertices, normals, texcoords, polygonal faces (fan-triangulated),
negative indices, groups ignored.  Produces GeomData directly or RIB text
via the port's tools/obj2rib.py (the exporters/ counterpart;
`python -m lucille_tpu_torch.tools.obj2rib model.obj`).

The port's copy of lucille_tpu/ri/wavefront.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lucille_tpu_torch.base.log import LOG_WARN, log
from lucille_tpu_torch.ri.types import AttributeState, GeomData


def load_obj(path, attrs: AttributeState | None = None) -> GeomData | None:
    """Parse an OBJ file into a single triangulated GeomData (object
    coordinates; callers transform)."""
    verts: list = []
    normals: list = []
    texcoords: list = []
    tris: list = []
    tri_vn: list = []
    tri_vt: list = []

    def resolve(i, n):
        i = int(i)
        return i - 1 if i > 0 else n + i

    for line in Path(path).read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v" and len(parts) >= 4:
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vn" and len(parts) >= 4:
            normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vt" and len(parts) >= 3:
            texcoords.append([float(parts[1]), float(parts[2])])
        elif tag == "f" and len(parts) >= 4:
            corners = []
            for tok in parts[1:]:
                comp = tok.split("/")
                vi = resolve(comp[0], len(verts))
                ti = (
                    resolve(comp[1], len(texcoords))
                    if len(comp) > 1 and comp[1]
                    else -1
                )
                ni = (
                    resolve(comp[2], len(normals))
                    if len(comp) > 2 and comp[2]
                    else -1
                )
                corners.append((vi, ti, ni))
            for k in range(1, len(corners) - 1):  # fan
                tris.append((corners[0][0], corners[k][0], corners[k + 1][0]))
                tri_vt.append((corners[0][1], corners[k][1], corners[k + 1][1]))
                tri_vn.append((corners[0][2], corners[k][2], corners[k + 1][2]))

    if not tris:
        log(LOG_WARN, "OBJ '%s' contains no faces", path)
        return None

    P = np.asarray(verts, dtype=np.float64)
    idx = np.asarray(tris, dtype=np.int32)
    geom = GeomData(
        positions=P,
        indices=idx,
        attrs=(attrs or AttributeState()).copy(),
        kind="polygon",
    )

    if normals and all(all(c >= 0 for c in t) for t in tri_vn):
        NA = np.asarray(normals, dtype=np.float64)
        vn = np.asarray(tri_vn, dtype=np.int64)
        # per-corner normals -> approximate per-vertex by first occurrence
        vert_n = np.zeros_like(P)
        counts = np.zeros(len(P))
        for t, (a, b, c) in enumerate(idx):
            for corner, vi in zip(vn[t], (a, b, c)):
                vert_n[vi] += NA[corner]
                counts[vi] += 1
        nz = counts > 0
        vert_n[nz] /= counts[nz, None]
        norms = np.linalg.norm(vert_n, axis=-1, keepdims=True)
        geom.normals = vert_n / np.maximum(norms, 1e-20)

    if texcoords and all(all(c >= 0 for c in t) for t in tri_vt):
        TA = np.asarray(texcoords, dtype=np.float64)
        vt = np.asarray(tri_vt, dtype=np.int64)
        geom.facevarying_st = TA[vt]  # (F, 3, 2)

    return geom
