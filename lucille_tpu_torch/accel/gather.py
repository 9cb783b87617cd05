"""The hemisphere gather: which one serves a scene, and the strata scan.

lucille_tpu's rule (transport/ao.py:136-148, :209-215; lights/sampling.py:
83-95) picks the gather of a scene's AO and dome strata (`gather_kind`):

- "fused-dense": kernel 3's fused gather (accel/ao.py, csrc/ao.cu) for
  its "pallas" request up to MAX_TRIS_FOR_MEGAKERNEL padded triangles;
- "bvh": the tile BVH's gather on pbvh (accel/bvh_ao.py: the cone-tiled
  gather, or the one LUCILLE_BVH_AO selects);
- "scan": every other accel (the dense tiles above the threshold,
  "bruteforce", "mxu", the grid) scans the strata, each stratum's rays,
  with their own jitter, through the any-hit (lucille_tpu's ao.py:173-195
  and :230-257).

Callers ask for a result, not a gather: `occlusion`, the occluded-strata
counts with the gather's walk counters; `sky_radiance`, the sunsky gather's
sky summed over the open strata; `fused_serves`, whether a fused gather
serves the scene at all (a constant dome light gathers through it, else
through its own cosine-weighted loop).

The jitter is drawn from `key`, a sampling/jitter.StreamKey, as
lucille_tpu draws it from its key: key.uniform((2, B)) for the fused and
tile-BVH gathers (column j belongs to compacted slot j on the dense
accel, the fused kernel's lane order, and to raster lane j on the tile
BVH, because lucille_tpu's `_stratified_dirs` draws on the unsorted
wavefront), key.fold(si).uniform((B, 2)) for stratum si of the scan.
"""

from __future__ import annotations

import math

import torch

from lucille_tpu_torch.accel.ao import (
    MAX_TRIS_FOR_MEGAKERNEL,
    ao_occlusion,
    ao_sunsky,
)
from lucille_tpu_torch.accel.bvh_ao import bvh_ao_occlusion, bvh_ao_sunsky
from lucille_tpu_torch.accel.dispatch import any_hit


def gather_kind(scene) -> str:
    """Which gather serves the scene's AO and dome strata, by lucille_tpu's
    rule (module docstring): "fused-dense", "bvh" or "scan"."""
    if scene.accel == "pbvh":
        return "bvh"
    if (scene.intersector == "pallas"
            and scene.tri_v0.shape[0] <= MAX_TRIS_FOR_MEGAKERNEL):
        return "fused-dense"
    return "scan"


def fused_serves(scene) -> bool:
    """Whether a fused gather serves the scene: the dense one, or the tile
    BVH's on a tree with nodes."""
    kind = gather_kind(scene)
    return kind == "fused-dense" or (kind == "bvh" and scene.n_nodes > 0)


def occlusion(scene, P_off, b0, b1, b2, hit, key, ntheta: int, nphi: int):
    """Occluded-strata counts for a wavefront of shading points.

    P_off, b0, b1, b2: (B, 3) f32 offset shading points and orthonormal
    basis (b2 = shading normal); hit: (B,) bool; key: the jitter's
    StreamKey (module docstring).  Returns ((B,) f32 counts of the
    ntheta * nphi strata, 0 where not hit; {ntrav, ntests} of the tile
    BVH gather's walks, else {})."""
    kind = gather_kind(scene)
    if kind == "scan":
        return _scan(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi,
                     torch.zeros(P_off.shape[0], dtype=torch.float32,
                                 device=P_off.device),
                     lambda occ, d: occ.to(torch.float32)), {}
    jitter = key.uniform((2, P_off.shape[0]))
    if kind == "bvh":
        return bvh_ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter,
                                ntheta, nphi)
    return ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter, ntheta,
                        nphi), {}


def sky_radiance(scene, P_off, b0, b1, b2, hit, key, ntheta: int, nphi: int,
                 sky):
    """The sunsky gather's sky: the Preetham sky radiance (B, 3) f32 along
    each hit lane's unoccluded strata, summed; 0 where not hit.  Operands
    as `occlusion`; sky a lights/sunsky.PreethamSunSky.  lucille_tpu drops
    this gather's counters (transport/ao.py:227-229); so does the port."""
    kind = gather_kind(scene)
    if kind == "scan":
        def open_sky(occ, d):
            return (~occ & hit)[:, None] * sky.sky_rgb_world(d)

        return _scan(scene, P_off, b0, b1, b2, hit, key, ntheta, nphi,
                     torch.zeros((P_off.shape[0], 3), dtype=torch.float32,
                                 device=P_off.device), open_sky)
    jitter = key.uniform((2, P_off.shape[0]))
    if kind == "bvh":
        return bvh_ao_sunsky(scene, P_off, b0, b1, b2, hit, jitter, ntheta,
                             nphi, sky)
    return ao_sunsky(scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi,
                     sky)


def scan_dirs(b0, b1, b2, ur, si: int, ntheta: int, nphi: int):
    """Stratum si's directions (B, 3) with uniforms ur (B, 2): the scans'
    own formulas (lucille_tpu/transport/ao.py:176-189) as written there,
    not stratum_directions': no R2 rotation, lz from cos_t squared."""
    z0 = (float(si % ntheta) + ur[:, 0]) / ntheta
    z1 = (float(si // ntheta) + ur[:, 1]) / nphi
    cos_t = torch.sqrt(z0)
    phi = 2.0 * math.pi * z1
    lx = torch.cos(phi) * cos_t
    ly = torch.sin(phi) * cos_t
    lz = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return lx[:, None] * b0 + ly[:, None] * b1 + lz[:, None] * b2


def _scan(scene, P_off, b0, b1, b2, hit, key, ntheta: int, nphi: int, acc,
          term):
    """The strata scan: stratum si's rays, with the jitter
    key.fold(si).uniform((B, 2)), through the any-hit (kernel 2 on the
    dense tiles), each stratum launched without a host sync;
    acc + term(occ (B,) bool, directions (B, 3)) summed in stratum
    order."""
    B = P_off.shape[0]
    for si in range(ntheta * nphi):
        wdir = scan_dirs(b0, b1, b2, key.fold(si).uniform((B, 2)), si,
                         ntheta, nphi)
        acc = acc + term(any_hit(scene, P_off, wdir, active=hit)["occ"],
                         wdir)
    return acc
