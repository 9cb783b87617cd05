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
  their pack for the kernels (accel/pack.pack_nodes), with the tree's
  depth and each leaf's count of real triangles (`leaf_real`,
  accel/tile_bvh.leaf_real: the any-hit and fused gather's warp walk
  stages no padding) beside it, and `tris` as on the dense accel.
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
    accel: str = "dense"  # "dense" or "pbvh" (module docstring)
    nodes: torch.Tensor | None = None  # (M, 8) pack_nodes layout, pbvh only
    tree_depth: int = 0  # depth of the deepest node, pbvh only
    leaf_real: torch.Tensor | None = None  # (M,) i32 real tris a leaf, pbvh
    # the kernels' packs (module docstring), built by from_numpy
    tris: torch.Tensor | None = None  # (16, Npad) pack_tris
    occ: torch.Tensor | None = None  # (16, Npad) pack_occ, dense only
    boxes: torch.Tensor | None = None  # (8, n_tiles) pack_boxes, dense only
    sboxes: torch.Tensor | None = None  # (8, n_super) pack_super_boxes, dense
    sub_boxes: torch.Tensor | None = None  # (8, Npad / SUB), dense only

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


ARRAY_FIELDS = tuple(
    f.name for f in fields(SceneTensors) if f.type == "torch.Tensor"
)
STATIC_FIELDS = ("n_tris", "n_pad", "n_geoms", "n_nodes", "leaf_tiles_max")
# lucille_tpu's name for the same triangle layout
DENSE_ACCELS = ("dense", "pallas")


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
    on `device`, f32/i32, same field names.  The dense layout ("pallas"
    or "dense") and the tile BVH ("pbvh") carry over; the kernels' packs,
    and for the tile BVH the node pack and the tree's depth, are computed
    here, once.  Any other accel raises."""
    accel = scene_arrays.accel
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
                 "leaf_real": _to_tensor(real, device)}
    else:
        raise NotImplementedError(
            f"accel {accel!r} is not ported: the port has the dense tiles "
            "and the tile BVH (the grid is ROADMAP Queue 1, item 7)"
        )
    kwargs = {f: _to_tensor(getattr(scene_arrays, f), device)
              for f in ARRAY_FIELDS}
    kwargs.update({f: getattr(scene_arrays, f) for f in STATIC_FIELDS})
    scene = SceneTensors(accel=accel, **kwargs, **extra)
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
