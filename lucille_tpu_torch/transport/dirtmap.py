"""Dirtmap integrator: distance-weighted ambient occlusion, in torch.

Counterpart of lucille_tpu/transport/dirtmap.py (the reference's
dirtmap.c:38-41, a Rind-style AO variant): like AO, but an occluder
darkens by how close it is, up to a gather distance, so the gather is a
closest hit with tmax = gather_dist rather than an any-hit.

Per eye ray: the closest hit, the shading frame (`transport/ao.
shading_frame`: interpolated normal, Frisvad basis, eps-offset origin),
then ntheta x nphi strata.  Stratum si draws its jitter from the tile's
stream at the path (si,), lucille_tpu's fold_in(key, si), builds its
directions with lucille_tpu's formulas (those of the AO scans,
`accel/gather.scan_dirs`), and traces them with the closest hit bounded
by gather_dist: dense tiles (kernel 1, csrc/isect.cu) or tile BVH
(kernel 4, csrc/bvh.cu).  A hit at t weighs max(0, 1 - t / gather_dist);
Lo = clip(1 - dirt / S, 0, 1) on the eye hits, 0 elsewhere.  The gather
passes the eye hits as its live lanes: a missed lane does no work, and
its radiance is 0 whatever its gather would give.

Counters as lucille_tpu reports them: nrays = B (1 + S), ntests and
ntrav the eye rays'.  No stratum waits on the card.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel.dispatch import closest_hit
from lucille_tpu_torch.accel.gather import scan_dirs
from lucille_tpu_torch.transport.ao import shading_frame


def dirtmap_radiance(scene, org, dirn, stream, ntheta: int, nphi: int,
                     gather_dist=None):
    """Dirtmap radiance (B, 3) of eye rays org, dirn (B, 3) f32 with the
    tile's random stream: 1 - mean(max(0, 1 - t / gather_dist)) over the
    hemisphere's strata.  gather_dist defaults to a quarter of the scene
    bounds' diagonal.  Returns (radiance, aux {hit, nrays, ntests,
    ntrav})."""
    B = org.shape[0]
    res = closest_hit(scene, org, dirn)
    hit = res["hit"]
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    if gather_dist is None:
        d = scene.bbox_max - scene.bbox_min
        gather_dist = 0.25 * torch.sqrt(d[0] * d[0] + d[1] * d[1]
                                        + d[2] * d[2])
    elif not torch.is_tensor(gather_dist):  # filled on the device, no copy
        gather_dist = torch.full((), float(gather_dist), dtype=torch.float32,
                                 device=org.device)
    tmax = gather_dist.expand(B).contiguous()

    nsamples = ntheta * nphi
    dirt = torch.zeros(B, dtype=torch.float32, device=org.device)
    for si in range(nsamples):
        wdir = scan_dirs(b0, b1, b2, stream.uniform((si,), (B, 2)), si,
                         ntheta, nphi)
        r = closest_hit(scene, P_off, wdir, tmax=tmax, active=hit)
        dirt = dirt + torch.where(
            r["hit"], torch.clamp_min(1.0 - r["t"] / gather_dist, 0.0), 0.0)
    lo = torch.clamp(1.0 - dirt / nsamples, 0.0, 1.0)
    radiance = torch.where(hit, lo, 0.0)[:, None].expand(B, 3).contiguous()
    return radiance, {"hit": hit, "nrays": B * (1 + nsamples),
                      "ntests": res["ntests"], "ntrav": res["ntrav"]}
