"""Tile BVH: the host build and the node arrays of the pbvh accel.

Host copies (NumPy) of lucille_tpu/accel/pallas_bvh.py:94-151
(`build_tile_bvh`) and :481-507 (`_node_arrays`), so that the port's leaf
layout, and with it every triangle id, equals lucille_tpu's:

- an SAH BVH (accel/bvh.py) whose leaves hold whole 128-triangle tiles:
  each leaf's triangle range is padded to tile boundaries, and the leaf
  size doubles until the node count fits `node_budget`;
- five meta rows per node, ``[skip, first_tile, n_tiles, far_child,
  split_axis]``, computed once when the scene is compiled.  Children are
  implicit in the DFS layout: child0 = i + 1 (the low side of the split
  axis), child1 = skip[i + 1].

The node budget (16384) is lucille_tpu's: a TPU scalar-memory ceiling.
The port keeps it so that the trees are the same; whether to lift it on
the H100 is an open question (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from lucille_tpu_torch.accel.bvh import build_bvh
from lucille_tpu_torch.accel.pack import TC

NODE_BUDGET = 16384


def build_tile_bvh(v0, v1, v2, node_budget: int = NODE_BUDGET):
    """SAH BVH with tile-aligned leaves.

    Returns (src, nbox, nmeta, n_nodes):
      src   : (n_leafpad,) int64, source triangle id per padded slot, -1
              for leaf-padding slots (callers scatter their per-triangle
              arrays through it; pads become all-zero triangles);
      nbox  : (6, M) f32 node bbox rows [min xyz | max xyz];
      nmeta : (3, M) i32 rows [skip, first_tile, n_tiles] (n_tiles = 0
              marks an inner node);
      n_nodes: M.
    """
    n = len(v0)
    leaf = TC
    while True:
        bvh = build_bvh(v0, v1, v2, leaf_size=leaf)
        if len(bvh.skip) <= node_budget or leaf >= n:
            break
        leaf *= 2

    m = len(bvh.skip)
    is_leaf = bvh.count > 0
    leaf_ids = np.flatnonzero(is_leaf)
    counts = bvh.count[leaf_ids].astype(np.int64)
    tiles_per_leaf = -(-counts // TC)
    first_tile = np.zeros(len(leaf_ids), dtype=np.int64)
    np.cumsum(tiles_per_leaf[:-1], out=first_tile[1:])
    n_tiles = int(tiles_per_leaf.sum()) if len(leaf_ids) else 1
    n_leafpad = n_tiles * TC

    # each leaf's (contiguous, DFS-ordered) triangle range into its
    # padded tile slots
    src = np.full(n_leafpad, -1, dtype=np.int64)
    for li, nid in enumerate(leaf_ids):
        f = bvh.first[nid]
        c = counts[li]
        dst = first_tile[li] * TC
        src[dst : dst + c] = bvh.order[f : f + c]

    nbox = np.zeros((6, m), dtype=np.float32)
    nbox[0:3] = bvh.bbmin.T
    nbox[3:6] = bvh.bbmax.T
    nmeta = np.zeros((3, m), dtype=np.int32)
    nmeta[0] = bvh.skip
    nmeta[1, leaf_ids] = first_tile
    nmeta[2, leaf_ids] = tiles_per_leaf
    return src, nbox, nmeta, m


def node_arrays(node_bbmin, node_bbmax, node_skip, node_first, node_count):
    """(6, M) f32 bbox rows + (5, M) i32 meta rows [skip, first_tile,
    n_tiles, far_child, split_axis], in lucille_tpu's f32 arithmetic.

    The far child is child1 = skip[i + 1] (0 on leaves); the split axis is
    the axis along which the two children's box centres differ most."""
    bbmin = np.asarray(node_bbmin, dtype=np.float32)
    bbmax = np.asarray(node_bbmax, dtype=np.float32)
    nbox = np.concatenate([bbmin.T, bbmax.T], axis=0)
    skip = np.asarray(node_skip).astype(np.int32)
    count = np.asarray(node_count).astype(np.int32)
    m = skip.shape[0]
    idx = np.arange(m, dtype=np.int32)
    c0 = np.minimum(idx + 1, m - 1)
    c1 = np.where(count > 0, 0, skip[c0])
    c1 = np.clip(c1, 0, m - 1).astype(np.int32)
    ctr = np.float32(0.5) * (bbmin + bbmax)
    axis = np.argmax(np.abs(ctr[c1] - ctr[c0]), axis=-1).astype(np.int32)
    nmeta = np.stack(
        [skip, np.asarray(node_first).astype(np.int32), count, c1, axis]
    )
    return nbox, nmeta


def leaf_real(node_first, node_count, tri_v0, tri_e1, tri_e2) -> np.ndarray:
    """(M,) int32: how many slots of each leaf's tile run hold real
    triangles, 0 on inner nodes (the warp walk of csrc/bvh.cu stages those
    and no padding).  A leaf's real triangles lead its run and its padding
    slots are all-zero triangles (build_tile_bvh's src < 0, in this
    package's compile and in lucille_tpu's), so the count is one past the
    run's last slot that is not all zero: build_tile_bvh's count of the
    leaf, unless a leaf's last real triangle has all three corners at the
    origin, which no test can hit.  Counted from the arrays, not from
    build_tile_bvh, because scene/types.from_numpy also takes lucille_tpu's
    SceneArrays, which do not carry the counts."""
    first = np.asarray(node_first).astype(np.int64)
    count = np.asarray(node_count).astype(np.int64)
    out = np.zeros(count.shape[0], dtype=np.int32)
    leaves = np.flatnonzero(count > 0)
    if len(leaves) == 0:
        return out
    tri = np.concatenate([np.asarray(a, dtype=np.float32).reshape(-1, 3)
                          for a in (tri_v0, tri_e1, tri_e2)], axis=1)
    n = tri.shape[0]
    slot = np.where((tri != 0).any(axis=1), np.arange(1, n + 1), 0)
    start = first[leaves] * TC  # leaves' runs are contiguous, in node order
    last = np.maximum.reduceat(slot, start)  # each run (the last to n)
    out[leaves] = np.clip(last - start, 0, count[leaves] * TC)
    return out


def tree_depth(nodes) -> int:
    """Depth of the deepest node of a `pack_nodes` pack (the root is at
    depth 0): the most entries a near-first walk holds on its stack."""
    bits = np.asarray(nodes).view(np.int32)
    inner, second = bits[:, 3] < 0, bits[:, 7]
    depth = np.zeros(bits.shape[0], dtype=np.int64)
    for i in np.flatnonzero(inner):  # DFS order: parents before children
        depth[i + 1] = depth[second[i]] = depth[i] + 1
    return int(depth.max())
