"""Accel dispatch: route intersection queries to the bound structure.

Counterpart of lucille_tpu/accel/dispatch.py:22-45 for the one accel the
port has, the dense Morton-sorted tiles (lucille_tpu's "pallas").
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel import isect
from lucille_tpu_torch.accel.pack import TC, pack_boxes, pack_tris


def closest_hit(scene, org: torch.Tensor, dirn: torch.Tensor) -> dict:
    """Closest hit of rays (B, 3) against the scene.  Returns the
    dispatch dict of lucille_tpu: t, u, v, tri (clamped to N - 1; -1 on a
    miss), hit, ntests, ntrav."""
    if scene.accel != "dense":
        raise NotImplementedError(f"accel {scene.accel!r} is not ported")
    res = isect.closest_hit(pack_tris(scene), pack_boxes(scene),
                            org.contiguous(), dirn.contiguous())
    tri = res["tri"]
    return {
        "t": res["t"],
        "u": res["u"],
        "v": res["v"],
        "tri": torch.clamp_max(tri, scene.tri_v0.shape[0] - 1),
        "hit": tri >= 0,
        "ntests": res["ntrav"] * (TC * isect.WARP),
        "ntrav": res["ntrav"],
    }
