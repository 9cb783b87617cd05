"""Per-ray BVH traversal diagnostics.

Counterpart of lucille_tpu/accel/traverse.py: `bvh_diag` walks each ray
through the tile BVH's skip-link arrays one node a step and reports, for
every ray, its node visits, leaf visits and triangle tests, the
reference's opt-in diagnostics (ri_bvh_diag_t, bvh.h:95-104) that feed
the BVH visualizer (tools/bvh_viz.py).  Per-ray exactness matters here
and speed does not: it is off every render path, so it is plain torch,
a lock-step walk that reads the device once a step (whether any ray is
still walking, and the longest leaf to test).

Node layout: the skip-link DFS arrays over tile-aligned leaves
(accel/tile_bvh.py); node_first / node_count are in tiles of TC
triangles, a leaf's triangles occupy [first TC, (first + count) TC), and
its padding is all-zero triangles that no ray can hit.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel.isect import mt_single

TC = 128  # triangles a tile (lucille_tpu/accel/pallas_isect.py TC)
SLAB_EPS = 1.0e-6


def _slab_test(bbmin, bbmax, org, inv_dir, t_best):
    """Ray-box slab test (test_ray_aabb, bvh.c:870): (B,) bool."""
    t0 = (bbmin - org) * inv_dir
    t1 = (bbmax - org) * inv_dir
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return (tnear <= tfar + SLAB_EPS) & (tfar > 0.0) & (tnear < t_best)


def bvh_diag(scene, org, dirn) -> dict:
    """Per-ray traversal diagnostics of rays org, dirn (B, 3) f32 through
    the scene's tile BVH (accel "pbvh"): {t, tri (-1 on a miss), hit, and
    the counters nvisits, nleafs, ntris (B,) i32}."""
    if scene.accel != "pbvh" or scene.n_nodes < 1:
        raise ValueError(f"bvh_diag needs a tile BVH, got accel "
                         f"{scene.accel!r} with {scene.n_nodes} nodes")
    B, dev = org.shape[0], org.device
    done = scene.n_nodes
    n_pad = scene.tri_v0.shape[0]
    inv_dir = 1.0 / torch.where(dirn.abs() > 1e-20, dirn, 1e-20)
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    node = zi.clone()
    t = torch.full((B,), float("inf"), device=dev)
    tri = zi - 1
    nvisits, nleafs, ntris = zi.clone(), zi.clone(), zi.clone()
    while bool((node < done).any()):
        active = node < done
        idx = torch.clamp_max(node, done - 1).long()
        count = scene.node_count[idx]
        first = scene.node_first[idx]
        box_hit = active & _slab_test(scene.node_bbmin[idx],
                                      scene.node_bbmax[idx], org, inv_dir, t)
        is_leaf = count > 0
        test_leaf = box_hit & is_leaf
        ntri_max = int(torch.where(test_leaf, count, 0).max()) * TC
        for k in range(ntri_max):
            m = test_leaf & (k < count * TC)
            ti = torch.clamp_max(first * TC + k, n_pad - 1)
            tl = ti.long()
            tt, _u, _v, hh = mt_single(org, dirn, scene.tri_v0[tl],
                                       scene.tri_e1[tl], scene.tri_e2[tl])
            better = m & hh & (tt > 0.0) & (tt < t)
            t = torch.where(better, tt, t)
            tri = torch.where(better, ti, tri)
            ntris = ntris + m.to(torch.int32)
        descend = box_hit & ~is_leaf
        nxt = torch.where(descend, idx.to(torch.int32) + 1,
                          scene.node_skip[idx])
        node = torch.where(active, nxt, done)
        nvisits = nvisits + active.to(torch.int32)
        nleafs = nleafs + test_leaf.to(torch.int32)
    return {"t": t, "tri": tri, "hit": tri >= 0, "nvisits": nvisits,
            "nleafs": nleafs, "ntris": ntris}
