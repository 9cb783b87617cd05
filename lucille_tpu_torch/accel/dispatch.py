"""Accel dispatch: route intersection queries to the bound structure.

Counterpart of lucille_tpu/accel/dispatch.py:22-69 for the port's three
layouts: the dense tiles (lucille_tpu's "pallas", Morton-sorted, and its
"bruteforce" and "mxu", in input order: csrc/isect.cu serves all three),
the tile BVH ("pbvh", csrc/bvh.cu) and the uniform grid ("ugrid",
csrc/ugrid.cu).
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel import bvh_isect, isect, ugrid


def closest_hit(scene, org: torch.Tensor, dirn: torch.Tensor,
                tmax=None, active=None) -> dict:
    """Closest hit of rays (B, 3) against the scene, with 0 < t < tmax
    (None: unbounded, a float or (B,), on both accels: the dense tiles
    take it where lucille_tpu switches to its MXU path); active: None or the
    (B,) bool live lanes of a bounce wavefront, a dead lane doing no work
    and reporting a miss on both accels (lucille_tpu's dense path
    compacts the live lanes, its BVH ignores the mask).  Returns the
    dispatch dict of lucille_tpu: t, u, v, tri (clamped to N - 1; -1 on a
    miss), hit, ntests, ntrav."""
    org, dirn = org.contiguous(), dirn.contiguous()
    if scene.accel == "pbvh":
        res = bvh_isect.bvh_closest_hit(scene.tris, scene.nodes, org,
                                        dirn, tmax, active,
                                        depth=scene.tree_depth,
                                        leaf_real=scene.leaf_real)
    elif scene.accel == "dense":
        res = isect.closest_hit(scene, org, dirn, tmax, active)
    elif scene.accel == "ugrid":
        res = ugrid.closest_hit(scene, org, dirn, tmax, active)
    else:
        raise NotImplementedError(f"accel {scene.accel!r} is not ported")
    tri = res["tri"]
    return {
        "t": res["t"],
        "u": res["u"],
        "v": res["v"],
        "tri": torch.clamp_max(tri, scene.tri_v0.shape[0] - 1),
        "hit": tri >= 0,
        "ntests": res["ntests"],
        "ntrav": res["ntrav"],
    }


def any_hit(scene, org: torch.Tensor, dirn: torch.Tensor,
            tmax=None, active=None) -> dict:
    """Whether each ray (B, 3) hits anything with 0 < t < tmax (None:
    unbounded, a float or (B,)); active: None or a (B,) bool mask of the
    rays that count, the others report False.  Returns {occ (B,) bool},
    on the tile BVH also ntrav, ntests.  On the dense tiles
    and the grid a dead ray costs no work (csrc/isect.cu, csrc/ugrid.cu);
    the tile BVH traces it and masks the answer, as lucille_tpu's BVH path
    ignores the mask (lucille_tpu/accel/dispatch.py:48-65)."""
    org, dirn = org.contiguous(), dirn.contiguous()
    if scene.accel == "pbvh":
        res = bvh_isect.bvh_any_hit(scene.tris, scene.nodes, org, dirn,
                                    tmax, depth=scene.tree_depth,
                                    leaf_real=scene.leaf_real)
        if active is not None:
            res["occ"] = res["occ"] & active
        return res
    if scene.accel == "dense":
        return isect.any_hit(scene, org, dirn, tmax, active)
    if scene.accel == "ugrid":
        return ugrid.any_hit(scene, org, dirn, tmax, active)
    raise NotImplementedError(f"accel {scene.accel!r} is not ported")
