"""Scene compiler: SceneDescription -> SceneTensors, dense accel only.

The host half is NumPy, copied from lucille_tpu/scene/compile.py's dense
branch so that the arrays come out identical (triangle ids are compared
exactly against the JAX package): triangle SoA in f32, geometric normals
where none are given, per-corner st and colours, the centroid Morton sort
that makes 128-triangle tiles spatially tight, zero-triangle padding to a
multiple of PAD_MULTIPLE, the scene-relative epsilon and the material
table.  The result is moved to the device once, by from_numpy.

`accel "auto"` decides by triangle count alone.  Scenes above
AUTO_DENSE_MAX_TRIS, and the tile-BVH and grid accels, are not ported yet.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from lucille_tpu.ri.types import SceneDescription
from lucille_tpu_torch.scene.types import SceneTensors, from_numpy

PAD_MULTIPLE = 256
EPS_SCALE = 1.0e-4
AUTO_DENSE_MAX_TRIS = 16384

_NOT_PORTED = "ROADMAP Queue 1: large-scene AO on the tile BVH"


def _morton_order(v0, v1, v2, bbmin, bbmax):
    """Stable sort order of triangles along the Morton curve of their
    centroids (lucille_tpu/scene/compile.py:31-50)."""
    c = ((v0 + v1 + v2) / 3.0).astype(np.float64)
    ext = np.maximum(np.asarray(bbmax) - np.asarray(bbmin), 1e-12)
    q = np.clip((c - bbmin) / ext * 1024.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (
        spread(q[:, 1]) << np.uint64(1)
    ) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _resolve_accel(requested: str, n_tris: int) -> None:
    if requested == "auto":
        if n_tris > AUTO_DENSE_MAX_TRIS:
            raise NotImplementedError(
                f"{n_tris} triangles is above the dense accel's "
                f"{AUTO_DENSE_MAX_TRIS}; the tile BVH is not ported yet "
                f"({_NOT_PORTED})"
            )
        return
    if requested != "pallas":
        raise NotImplementedError(
            f"accel {requested!r} is not ported; use 'auto' or 'pallas' "
            f"(the dense accel) ({_NOT_PORTED})"
        )


def _per_triangle(g):
    """One geom's per-corner arrays, f32 before the gathers."""
    idx = g.indices
    P = np.asarray(g.positions, dtype=np.float32)
    a, b, c = P[idx[:, 0]], P[idx[:, 1]], P[idx[:, 2]]
    if g.normals is not None:
        Nv = np.asarray(g.normals, dtype=np.float32)
        ns = (Nv[idx[:, 0]], Nv[idx[:, 1]], Nv[idx[:, 2]])
    else:
        ng = np.cross(b - a, c - a)
        nrm = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.maximum(nrm, 1e-20)
        ns = (ng, ng, ng)
    if g.facevarying_st is not None:
        fst = np.asarray(g.facevarying_st, dtype=np.float32)
        sts = (fst[:, 0], fst[:, 1], fst[:, 2])
    elif g.st is not None:
        st = np.asarray(g.st, dtype=np.float32)
        sts = (st[idx[:, 0]], st[idx[:, 1]], st[idx[:, 2]])
    else:
        z = np.zeros((len(idx), 2), dtype=np.float32)
        sts = (z, z, z)
    if g.colors is not None:
        C = np.asarray(g.colors, dtype=np.float32)
        cs = (C[idx[:, 0]], C[idx[:, 1]], C[idx[:, 2]])
    else:
        o = np.ones((len(idx), 3), dtype=np.float32)
        cs = (o, o, o)
    return (a, b, c), ns, sts, cs


def compile_arrays(desc: SceneDescription) -> SimpleNamespace:
    """The dense scene as host NumPy arrays (field names as SceneTensors)."""
    geoms = [g for g in desc.geoms if g.ntriangles > 0]
    n_geoms = max(1, len(geoms))
    per = [_per_triangle(g) for g in geoms]
    cat = lambda k, j: np.concatenate([p[k][j] for p in per])  # noqa: E731

    if per:
        v0, v1, v2 = cat(0, 0), cat(0, 1), cat(0, 2)
        geom_id = np.concatenate(
            [np.full(g.ntriangles, gi, dtype=np.int32)
             for gi, g in enumerate(geoms)]
        )
        n0, n1, n2 = cat(1, 0), cat(1, 1), cat(1, 2)
        st0, st1, st2 = cat(2, 0), cat(2, 1), cat(2, 2)
        c0, c1, c2 = cat(3, 0), cat(3, 1), cat(3, 2)
    else:
        v0 = v1 = v2 = np.zeros((0, 3))
        geom_id = np.zeros(0, dtype=np.int32)
        n0 = n1 = n2 = np.zeros((0, 3))
        st0 = st1 = st2 = np.zeros((0, 2))
        c0 = c1 = c2 = np.zeros((0, 3))
    n_tris = len(v0)
    _resolve_accel(desc.options.accel_method, n_tris)

    if n_tris:
        allv = np.concatenate([v0, v1, v2])
        bbmin = allv.min(axis=0)
        bbmax = allv.max(axis=0)
    else:
        bbmin = np.zeros(3)
        bbmax = np.ones(3)
    eps = max(float(np.linalg.norm(bbmax - bbmin)), 1.0) * EPS_SCALE

    if n_tris > 1:
        order = _morton_order(v0, v1, v2, bbmin, bbmax)
        v0, v1, v2 = v0[order], v1[order], v2[order]
        geom_id = geom_id[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]
        st0, st1, st2 = st0[order], st1[order], st2[order]
        c0, c1, c2 = c0[order], c1[order], c2[order]

    n_pad = max(PAD_MULTIPLE, -(-max(n_tris, 1) // PAD_MULTIPLE) * PAD_MULTIPLE)

    def pad(a):
        filler = np.zeros((n_pad - len(a),) + a.shape[1:], dtype=a.dtype)
        return np.concatenate([a, filler])

    mat_kd = np.ones(n_geoms)
    mat_ks = np.zeros(n_geoms)
    mat_kt = np.zeros(n_geoms)
    mat_ior = np.ones(n_geoms)
    mat_roughness = np.full(n_geoms, 0.1)
    mat_color = np.ones((n_geoms, 3))
    mat_texture = np.full(n_geoms, -1, dtype=np.int32)
    mat_emission = np.zeros((n_geoms, 3))
    for gi, g in enumerate(geoms):
        a = g.attrs
        mat_kd[gi] = a.material.kd
        mat_ks[gi] = a.material.ks
        mat_kt[gi] = a.material.kt
        mat_ior[gi] = a.material.ior
        mat_roughness[gi] = a.material.roughness
        mat_color[gi] = np.asarray(a.color)
        if 0 <= a.area_light_index < len(desc.lights):
            li = desc.lights[a.area_light_index]
            mat_emission[gi] = np.asarray(li.color) * li.intensity

    return SimpleNamespace(
        tri_v0=pad(v0), tri_e1=pad(v1 - v0), tri_e2=pad(v2 - v0),
        geom_id=pad(geom_id),
        n0=pad(n0), n1=pad(n1), n2=pad(n2),
        st0=pad(st0), st1=pad(st1), st2=pad(st2),
        c0=pad(c0), c1=pad(c1), c2=pad(c2),
        mat_kd=mat_kd, mat_ks=mat_ks, mat_kt=mat_kt, mat_ior=mat_ior,
        mat_color=mat_color, mat_texture=mat_texture,
        mat_emission=mat_emission, mat_roughness=mat_roughness,
        bbox_min=bbmin, bbox_max=bbmax, eps=np.float32(eps),
        n_tris=n_tris, n_pad=n_pad, n_geoms=n_geoms, accel="dense",
    )


def compile_scene(desc: SceneDescription, device) -> SceneTensors:
    """SceneDescription -> SceneTensors on `device` (dense accel)."""
    return from_numpy(compile_arrays(desc), device)
