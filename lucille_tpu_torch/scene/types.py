"""Device scene representation: padded SoA tensors.

The counterpart of lucille_tpu/scene/types.py for the port's two accels:
flat per-triangle arrays indexed by triangle id (pad entries are all-zero
triangles that no intersector can hit), the material table, the tile-BVH
node arrays, the scene bounds and the scene-relative ray epsilon.  Floats
are f32, integers i32, on one explicit device.

- accel "dense": the triangles Morton-sorted into 128-triangle tiles
  (lucille_tpu's "pallas"); the node arrays are lucille_tpu's one-entry
  placeholders and n_nodes is 0.  The kernels' packs are built once,
  here: `tris` (accel/pack.pack_tris) for the closest hit and any-hit,
  `occ`, `boxes`, `sboxes` and `sub_boxes` (pack_occ, pack_boxes,
  pack_super_boxes, pack_boxes at SUB triangles) for the AO gather and
  the tile culls.
- accel "pbvh": the triangles in the tile BVH's leaf order, every leaf
  padded to whole tiles; the node arrays are the tree, and `nodes` is
  their pack for the kernels (accel/pack.pack_nodes; the arrays
  themselves are kept for accel/traverse.bvh_diag), with the tree's
  depth and each leaf's count of real triangles (`leaf_real`,
  accel/tile_bvh.leaf_real: the any-hit and fused gather's warp walk
  stages no padding) beside it, and `tris` as on the dense accel.
- accel "ugrid": lucille_tpu's uniform grid (accel/ugrid.py), the
  triangles in input order: `grid_cell_start` and `grid_tri_idx` (the
  CSR cell lists), `grid_box` (6,) [bbmin | bbmax] and `grid_res`; and
  the walk's two packs, built once by the compile (scene/compile.py,
  accel/ugrid.grid_packs): `grid_occupied`, one bit a cell that lists a
  slot, and `grid_tris`, each slot's triangle in slot order.

`intersector` keeps lucille_tpu's accel name for the scene ("pallas",
"mxu", "bruteforce", "ugrid" or "pbvh"): lucille_tpu's "mxu" and
"bruteforce" are the dense layout here, its kernels serving them, and
the gathers choose by the name as lucille_tpu does
(transport/ao.gather_kind).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from lucille_tpu_torch.accel.pack import (
    SUB,
    pack_boxes,
    pack_occ,
    pack_super_boxes,
    pack_tris,
)


@dataclass(frozen=True)
class SceneTensors:
    # triangles (padded to n_pad)
    tri_v0: torch.Tensor  # (N, 3) f32
    tri_e1: torch.Tensor  # (N, 3) f32  v1 - v0
    tri_e2: torch.Tensor  # (N, 3) f32  v2 - v0
    geom_id: torch.Tensor  # (N,) i32 -> material row

    # per-corner shading attributes, already per triangle
    n0: torch.Tensor  # (N, 3) f32
    n1: torch.Tensor
    n2: torch.Tensor
    st0: torch.Tensor  # (N, 2) f32
    st1: torch.Tensor
    st2: torch.Tensor
    c0: torch.Tensor  # (N, 3) f32 vertex colour, default 1
    c1: torch.Tensor
    c2: torch.Tensor

    # material table, one row per geom
    mat_kd: torch.Tensor  # (G,) f32
    mat_ks: torch.Tensor
    mat_kt: torch.Tensor
    mat_ior: torch.Tensor
    mat_color: torch.Tensor  # (G, 3) f32
    mat_texture: torch.Tensor  # (G,) i32, -1 = none
    mat_emission: torch.Tensor  # (G, 3) f32
    mat_roughness: torch.Tensor  # (G,) f32

    # bounds and epsilon
    bbox_min: torch.Tensor  # (3,) f32
    bbox_max: torch.Tensor  # (3,) f32
    eps: torch.Tensor  # () f32

    # static metadata
    n_tris: int = 0  # real triangle count
    n_pad: int = 0  # padded count
    n_geoms: int = 0
    n_nodes: int = 0  # tile-BVH nodes, 0 on the dense accel
    leaf_tiles_max: int = 1  # most tiles in one leaf
    accel: str = "dense"  # "dense", "pbvh" or "ugrid" (module docstring)
    nodes: torch.Tensor | None = None  # (M, 8) pack_nodes layout, pbvh only
    tree_depth: int = 0  # depth of the deepest node, pbvh only
    leaf_real: torch.Tensor | None = None  # (M,) i32 real tris a leaf, pbvh
    # the tree's skip-link arrays, pbvh only (accel/traverse.bvh_diag)
    node_bbmin: torch.Tensor | None = None  # (M, 3) f32
    node_bbmax: torch.Tensor | None = None  # (M, 3) f32
    node_skip: torch.Tensor | None = None  # (M,) i32
    node_first: torch.Tensor | None = None  # (M,) i32, in tiles
    node_count: torch.Tensor | None = None  # (M,) i32 tiles, 0 inner
    # the kernels' packs (module docstring), built by from_numpy
    tris: torch.Tensor | None = None  # (16, Npad) pack_tris
    occ: torch.Tensor | None = None  # (16, Npad) pack_occ, dense only
    boxes: torch.Tensor | None = None  # (8, n_tiles) pack_boxes, dense only
    sboxes: torch.Tensor | None = None  # (8, n_super) pack_super_boxes, dense
    sub_boxes: torch.Tensor | None = None  # (8, Npad / SUB), dense only
    # lucille_tpu's accel name (module docstring)
    intersector: str = "pallas"
    # the uniform grid, ugrid only (module docstring)
    grid_cell_start: torch.Tensor | None = None  # (res^3 + 1,) i32
    grid_tri_idx: torch.Tensor | None = None  # (M,) i32
    grid_box: torch.Tensor | None = None  # (6,) f32 [bbmin | bbmax]
    grid_res: int = 0
    grid_occupied: torch.Tensor | None = None  # (ceil(res^3 / 32),) i32
    grid_tris: torch.Tensor | None = None  # (M, 12) f32 slot-order pack

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


ARRAY_FIELDS = tuple(
    f.name for f in fields(SceneTensors) if f.type == "torch.Tensor"
)
NODE_FIELDS = ("node_bbmin", "node_bbmax", "node_skip", "node_first",
               "node_count")
STATIC_FIELDS = ("n_tris", "n_pad", "n_geoms", "n_nodes", "leaf_tiles_max")
# lucille_tpu's names for the dense triangle layout ("dense" is the port's
# compile output, whose `intersector` says which)
DENSE_ACCELS = ("dense", "pallas", "mxu", "bruteforce")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    else:
        raise TypeError(f"unsupported scene array dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_numpy(scene_arrays, device) -> SceneTensors:
    """Any object carrying the scene fields as NumPy arrays (the JAX
    package's SceneArrays, or this package's compile output) -> tensors
    on `device`, f32/i32, same field names.  The dense layout ("pallas",
    "mxu", "bruteforce" or "dense"), the tile BVH ("pbvh") and the grid
    ("ugrid") carry over; the kernels' packs, and for the tile BVH the
    node pack and the tree's depth, are built here, once; the grid's
    walk packs come built with its CSR table from this package's compile
    (scene/compile.py) and are only copied, and are built here only for
    lucille_tpu's arrays, which lack them.  Any other accel raises."""
    accel = scene_arrays.accel
    intersector = getattr(scene_arrays, "intersector", None) or (
        "pallas" if accel == "dense" else accel)
    extra = {}
    if accel in DENSE_ACCELS:
        accel = "dense"
    elif accel == "pbvh" and scene_arrays.n_nodes > 0:
        from lucille_tpu_torch.accel.pack import pack_nodes
        from lucille_tpu_torch.accel.tile_bvh import leaf_real, tree_depth

        nodes = pack_nodes(scene_arrays)
        real = leaf_real(scene_arrays.node_first, scene_arrays.node_count,
                         scene_arrays.tri_v0, scene_arrays.tri_e1,
                         scene_arrays.tri_e2)
        extra = {"nodes": nodes.to(device), "tree_depth": tree_depth(nodes),
                 "leaf_real": _to_tensor(real, device),
                 **{f: _to_tensor(getattr(scene_arrays, f), device)
                    for f in NODE_FIELDS}}
    elif accel == "ugrid" and scene_arrays.grid_res > 0:
        box = np.concatenate([scene_arrays.grid_bbmin,
                              scene_arrays.grid_bbmax])
        occupied = getattr(scene_arrays, "grid_occupied", None)
        tris = getattr(scene_arrays, "grid_tris", None)
        if occupied is None:  # lucille_tpu's arrays carry no walk packs
            from lucille_tpu_torch.accel.ugrid import grid_packs

            occupied, tris = grid_packs(
                scene_arrays.grid_cell_start, scene_arrays.grid_tri_idx,
                scene_arrays.tri_v0, scene_arrays.tri_e1,
                scene_arrays.tri_e2)
        extra = {"grid_cell_start": _to_tensor(scene_arrays.grid_cell_start,
                                               device),
                 "grid_tri_idx": _to_tensor(scene_arrays.grid_tri_idx, device),
                 "grid_box": _to_tensor(box, device),
                 "grid_res": int(scene_arrays.grid_res),
                 "grid_occupied": _to_tensor(occupied, device),
                 "grid_tris": _to_tensor(tris, device)}
    else:
        raise NotImplementedError(
            f"accel {accel!r} (n_nodes {getattr(scene_arrays, 'n_nodes', 0)}"
            f", grid_res {getattr(scene_arrays, 'grid_res', 0)}): the port "
            "takes the dense tiles, a built tile BVH and a built grid"
        )
    kwargs = {f: _to_tensor(getattr(scene_arrays, f), device)
              for f in ARRAY_FIELDS}
    kwargs.update({f: getattr(scene_arrays, f) for f in STATIC_FIELDS})
    scene = SceneTensors(accel=accel, intersector=intersector, **kwargs,
                         **extra)
    if accel == "ugrid":
        return scene
    packs = {"tris": pack_tris(scene)}
    if accel == "dense":
        boxes = pack_boxes(scene)
        packs.update(occ=pack_occ(scene), boxes=boxes,
                     sboxes=pack_super_boxes(boxes),
                     sub_boxes=pack_boxes(scene, SUB))
    return replace(scene, **packs)


def to_numpy(scene: SceneTensors) -> dict:
    """Array fields back on the host, as a {name: ndarray} dict."""
    return {f: getattr(scene, f).cpu().numpy() for f in ARRAY_FIELDS}
