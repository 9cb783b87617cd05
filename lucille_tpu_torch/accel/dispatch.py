"""Accel dispatch: route intersection queries to the bound structure.

Counterpart of lucille_tpu/accel/dispatch.py:22-69 for the port's two
accels: the dense Morton-sorted tiles (lucille_tpu's "pallas") and the
tile BVH ("pbvh").
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel import bvh_isect, isect
from lucille_tpu_torch.accel.pack import TC, pack_boxes, pack_tris


def closest_hit(scene, org: torch.Tensor, dirn: torch.Tensor,
                tmax=None) -> dict:
    """Closest hit of rays (B, 3) against the scene, with 0 < t < tmax
    (None: unbounded; the dense tiles take no tmax).  Returns the
    dispatch dict of lucille_tpu: t, u, v, tri (clamped to N - 1; -1 on a
    miss), hit, ntests, ntrav."""
    org, dirn = org.contiguous(), dirn.contiguous()
    if scene.accel == "pbvh":
        res = bvh_isect.bvh_closest_hit(pack_tris(scene), scene.nodes, org,
                                        dirn, tmax, depth=scene.tree_depth)
    elif scene.accel == "dense":
        if tmax is not None:
            raise NotImplementedError(
                "the dense closest hit takes no tmax (lucille_tpu serves it "
                "with its MXU path, which is not ported)")
        res = isect.closest_hit(pack_tris(scene), pack_boxes(scene), org,
                                dirn)
        res["ntests"] = res["ntrav"] * (TC * isect.WARP)
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
            tmax=None) -> dict:
    """Whether each ray (B, 3) hits anything with 0 < t < tmax (None:
    unbounded).  Returns {occ (B,) bool, ntrav, ntests}.  Served on the
    tile BVH; the dense any-hit (kernel 2 of ROADMAP Queue 2,
    pallas_isect.py:_anyhit_kernel) is still to port."""
    if scene.accel != "pbvh":
        raise NotImplementedError(
            f"any-hit on accel {scene.accel!r}: the dense any-hit kernel "
            "(pallas_isect.py:_anyhit_kernel) is not ported yet "
            "(ROADMAP Queue 2)")
    return bvh_isect.bvh_any_hit(pack_tris(scene), scene.nodes,
                                 org.contiguous(), dirn.contiguous(), tmax,
                                 depth=scene.tree_depth)
