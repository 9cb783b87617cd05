"""Triangle, box and node packs the kernels read.

Counterparts of lucille_tpu/accel/pallas_isect.py:207-267 (`_pack`,
`_pack_boxes`, `_pack_super_boxes`) and pallas_ao.py:511-526
(`_pack_occ`).  Rows are components, columns triangles or tiles, so a
kernel stages one 128-triangle tile with coalesced row reads.  The tile
BVH kernels read `pack_tris` too, and their nodes from `pack_nodes`.
"""

from __future__ import annotations

import numpy as np
import torch

TC = 128  # triangles per tile
SUPER = 16  # tiles per supertile
SUB = 8  # triangles per sub-tile box (the AO gather's finest cull)


def _cols(n_pad: int, rows, device) -> torch.Tensor:
    """(16, npad) f32 matrix, `rows` (each (N, 3)) stacked from row 0."""
    npad = -(-n_pad // TC) * TC
    out = torch.zeros((16, npad), dtype=torch.float32, device=device)
    for i, r in enumerate(rows):
        out[3 * i : 3 * i + 3, : r.shape[0]] = r.T
    return out


def pack_tris(scene) -> torch.Tensor:
    """(16, Npad) rows [v0 | e1 | e2 | 0...] for the closest-hit kernel."""
    return _cols(scene.n_pad, (scene.tri_v0, scene.tri_e1, scene.tri_e2),
                 scene.device)


def pack_occ(scene) -> torch.Tensor:
    """(16, Npad) rows [v0 | v1 | v2 | n | 0...] for the AO kernel, with
    v1 = v0 + e1, v2 = v0 + e2 and n = e1 x e2.  Pad triangles are all
    zeros: every triple product vanishes, so they never occlude."""
    e1, e2 = scene.tri_e1, scene.tri_e2
    nrm = torch.stack(
        [
            e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
            e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
            e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
        ],
        dim=-1,
    )
    v0 = scene.tri_v0
    return _cols(scene.n_pad, (v0, v0 + e1, v0 + e2, nrm), scene.device)


def pack_boxes(scene, tc: int = TC) -> torch.Tensor:
    """Per-tile AABBs -> (8, n_tiles) f32, rows [min xyz | max xyz | 0 0];
    with tc=SUB the AO gather's sub-tile boxes.  Pad triangles contribute
    +inf/-inf, so they never widen a box."""
    n = scene.tri_v0.shape[0]
    npad = -(-n // tc) * tc
    v0 = scene.tri_v0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    mins = torch.minimum(torch.minimum(v0, v1), v2)
    maxs = torch.maximum(torch.maximum(v0, v1), v2)
    real = (torch.arange(n, device=v0.device) < scene.n_tris)[:, None]
    mins = torch.where(real, mins, float("inf"))
    maxs = torch.where(real, maxs, float("-inf"))
    if npad > n:
        fill = torch.full((npad - n, 3), float("inf"), device=v0.device)
        mins = torch.cat([mins, fill])
        maxs = torch.cat([maxs, -fill])
    n_tiles = npad // tc
    boxes = torch.zeros((8, n_tiles), dtype=torch.float32, device=v0.device)
    boxes[0:3] = mins.reshape(n_tiles, tc, 3).amin(dim=1).T
    boxes[3:6] = maxs.reshape(n_tiles, tc, 3).amax(dim=1).T
    return boxes


def pack_super_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Tile boxes (8, n_tiles) -> supertile boxes (8, n_super): groups of
    SUPER consecutive (Morton-ordered) tiles."""
    n_tiles = boxes.shape[1]
    n_super = -(-n_tiles // SUPER)
    pad = n_super * SUPER - n_tiles
    bmin = boxes[0:3]
    bmax = boxes[3:6]
    if pad:
        fill = torch.full((3, pad), float("inf"), device=boxes.device)
        bmin = torch.cat([bmin, fill], dim=1)
        bmax = torch.cat([bmax, -fill], dim=1)
    out = torch.zeros((8, n_super), dtype=torch.float32, device=boxes.device)
    out[0:3] = bmin.reshape(3, n_super, SUPER).amin(dim=2)
    out[3:6] = bmax.reshape(3, n_super, SUPER).amax(dim=2)
    return out


def pack_nodes(scene) -> torch.Tensor:
    """Tile-BVH nodes as (M, 8) f32, two 16-byte words a node, for
    csrc/bvh.cu:

        [min x, min y, min z, A | max x, max y, max z, C]

    A and C are int32 bit patterns: a leaf has A = n_tiles > 0 and C =
    first_tile; an inner node has A = -(split_axis + 1) and C = its
    second child (the first is the next node, on the low side of the
    split axis).  `scene` carries the node_*
    fields on the host (NumPy arrays or CPU tensors); the pack is built
    once, when the scene is compiled, on the CPU."""
    from lucille_tpu_torch.accel.tile_bvh import node_arrays

    nbox, nmeta = node_arrays(scene.node_bbmin, scene.node_bbmax,
                              scene.node_skip, scene.node_first,
                              scene.node_count)
    m = nbox.shape[1]
    out = np.zeros((m, 8), dtype=np.float32)
    out[:, 0:3] = nbox[0:3].T
    out[:, 4:7] = nbox[3:6].T
    bits = out.view(np.int32)
    leaf = nmeta[2] > 0
    bits[:, 3] = np.where(leaf, nmeta[2], -(nmeta[4] + 1))
    bits[:, 7] = np.where(leaf, nmeta[1], nmeta[3])
    return torch.from_numpy(out)
