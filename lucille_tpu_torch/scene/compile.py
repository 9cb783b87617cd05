"""Scene compiler: SceneDescription -> SceneTensors (dense or tile BVH).

The host half is NumPy, copied from lucille_tpu/scene/compile.py's dense
and pbvh branches so that the arrays come out identical (triangle ids are
compared exactly against the JAX package): triangle SoA in f32, geometric
normals where none are given, per-corner st and colours, then either

- dense: the centroid Morton sort that makes 128-triangle tiles
  spatially tight, or
- pbvh: the tile BVH (accel/tile_bvh.py), every per-triangle array
  scattered into its leaf slots, pad slots all-zero triangles,

then zero-triangle padding to a multiple of PAD_MULTIPLE, the
scene-relative epsilon and the material table.  The result is moved to
the device once, by from_numpy.

`accel "auto"` decides by triangle count alone: dense up to
AUTO_DENSE_MAX_TRIS, the tile BVH above.  "pallas" asks for the dense
tiles, "bvh" and "pbvh" for the tile BVH, "grid" and "ugrid" for the
uniform grid (accel/ugrid.py's CSR build and the walk's two packs,
`grid_*` arrays), and
"bruteforce" and "mxu", lucille_tpu's dense intersectors, for the dense
tiles with the triangles in input order: lucille_tpu Morton-sorts them
only for "pallas" (lucille_tpu/scene/compile.py:232), and the port's
dense kernels serve both requests (bruteforce.py and mxu.py have the
dense kernels' contract).  Any other name is "bruteforce", as in
lucille_tpu.  The output keeps lucille_tpu's name for the request in
`intersector`: the AO and dome gathers choose by it as lucille_tpu does
(transport/ao.gather_kind).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from lucille_tpu_torch.base.log import LOG_INFO, log
from lucille_tpu_torch.base.timer import get_timer
from lucille_tpu_torch.ri.types import SceneDescription
from lucille_tpu_torch.scene.types import SceneTensors, from_numpy

PAD_MULTIPLE = 256
EPS_SCALE = 1.0e-4
AUTO_DENSE_MAX_TRIS = 16384


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


def resolve_accel(requested: str, n_tris: int) -> tuple[str, str]:
    """The RIB's accel request -> (the port's layout, "dense", "pbvh" or
    "ugrid"; lucille_tpu's intersector, "pallas", "pbvh", "ugrid",
    "bruteforce" or "mxu")."""
    if requested == "auto":
        return (("pbvh", "pbvh") if n_tris > AUTO_DENSE_MAX_TRIS
                else ("dense", "pallas"))
    if requested in ("bvh", "pbvh"):
        return "pbvh", "pbvh"
    if requested in ("grid", "ugrid"):
        return "ugrid", "ugrid"
    if requested in ("pallas", "mxu"):
        return "dense", requested
    return "dense", "bruteforce"


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


def compile_arrays(desc: SceneDescription, texture_ids: dict | None = None,
                   build_bvh: bool = False) -> SimpleNamespace:
    """The scene as host NumPy arrays (field names as SceneTensors).
    texture_ids: {texture file name: atlas id}, assigned by the renderer
    after it loads the atlas (texture/texture.py); a material whose
    texture has no id keeps -1.  build_bvh: the tile BVH whatever the
    request (the BVH visualizer's diagnostics, tools/bvh_viz.py), as
    lucille_tpu's compile_scene(build_bvh=True)."""
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
    accel, intersector = resolve_accel(
        "pbvh" if build_bvh else desc.options.accel_method, n_tris)

    if n_tris:
        allv = np.concatenate([v0, v1, v2])
        bbmin = allv.min(axis=0)
        bbmax = allv.max(axis=0)
    else:
        bbmin = np.zeros(3)
        bbmax = np.ones(3)
    eps = max(float(np.linalg.norm(bbmax - bbmin)), 1.0) * EPS_SCALE

    # lucille_tpu's placeholders where there is no tree
    node_bbmin = node_bbmax = np.zeros((1, 3))
    node_skip = np.ones(1, dtype=np.int32)
    node_first = node_count = np.zeros(1, dtype=np.int32)
    n_nodes, leaf_tiles_max = 0, 1
    per_tri = [v0, v1, v2, geom_id, n0, n1, n2, st0, st1, st2, c0, c1, c2]
    if accel == "pbvh" and n_tris > 0:
        from lucille_tpu_torch.accel.tile_bvh import build_tile_bvh

        timer = get_timer()
        timer.start("BVH Construction")
        src, nbox, nmeta, n_nodes = build_tile_bvh(v0, v1, v2)
        dt = timer.end("BVH Construction")
        log(LOG_INFO, "tile BVH built: %d tris -> %d padded, %d nodes, "
            "%.3f sec", n_tris, len(src), n_nodes, dt)
        # per-triangle arrays into the leaf slots; pads become all-zero
        # triangles that no intersector can hit
        take = np.maximum(src, 0)
        holes = src < 0

        def scat(a):
            out = np.ascontiguousarray(a[take])
            out[holes] = 0
            return out

        per_tri = [scat(a) for a in per_tri]
        node_bbmin, node_bbmax = nbox[0:3].T, nbox[3:6].T
        node_skip, node_first, node_count = nmeta
        leaf_tiles_max = int(nmeta[2].max())
    else:
        if accel == "pbvh":
            accel, intersector = "dense", "pallas"  # no triangle to build on
        if intersector == "pallas" and n_tris > 1:
            order = _morton_order(v0, v1, v2, bbmin, bbmax)
            per_tri = [a[order] for a in per_tri]
    v0, v1, v2, geom_id, n0, n1, n2, st0, st1, st2, c0, c1, c2 = per_tri

    # the uniform grid over the unpadded triangles (lucille_tpu/scene/
    # compile.py:243-271); without a triangle the scene stays dense
    grid = {}
    if accel == "ugrid" and n_tris > 0:
        from lucille_tpu_torch.accel.ugrid import build_ugrid, grid_packs

        timer = get_timer()
        timer.start("Grid Construction")
        g = build_ugrid(v0, v1, v2)
        dt = timer.end("Grid Construction")
        log(LOG_INFO, "uniform grid built: %d tris, %d^3 cells, %d refs, "
            "%.3f sec", n_tris, g.res, len(g.tri_idx), dt)
        occupied, tris = grid_packs(g.cell_start, g.tri_idx, v0, v1 - v0,
                                    v2 - v0)
        grid = dict(grid_cell_start=g.cell_start, grid_tri_idx=g.tri_idx,
                    grid_bbmin=g.bbmin, grid_bbmax=g.bbmax, grid_res=g.res,
                    grid_occupied=occupied, grid_tris=tris)
    elif accel == "ugrid":
        accel = "dense"

    # pbvh arrays are already tile-padded (len(v0) >= n_tris)
    n_pad = max(PAD_MULTIPLE, -(-max(len(v0), 1) // PAD_MULTIPLE) * PAD_MULTIPLE)

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
        if texture_ids and a.material.texture:
            mat_texture[gi] = texture_ids.get(a.material.texture, -1)
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
        node_bbmin=node_bbmin, node_bbmax=node_bbmax, node_skip=node_skip,
        node_first=node_first, node_count=node_count,
        bbox_min=bbmin, bbox_max=bbmax, eps=np.float32(eps),
        n_tris=n_tris, n_pad=n_pad, n_geoms=n_geoms, n_nodes=n_nodes,
        leaf_tiles_max=leaf_tiles_max, accel=accel, intersector=intersector,
        **grid,
    )


def compile_scene(desc: SceneDescription, device,
                  texture_ids: dict | None = None,
                  build_bvh: bool = False) -> SceneTensors:
    """SceneDescription -> SceneTensors on `device` (texture_ids and
    build_bvh as compile_arrays)."""
    return from_numpy(compile_arrays(desc, texture_ids, build_bvh), device)
