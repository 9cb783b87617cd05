"""AO gather on the tile BVH: lucille_tpu's cone-tiled gather rays through
the BVH any-hit kernel.

Counterpart of lucille_tpu/accel/pallas_bvh.py:965-1233 in its default
"cone" mode (`pallas_bvh_ao_occlusion` -> `_pallas_bvh_ao_conetiled`):

- every hit lane gets S = ntheta * nphi stratified cosine directions
  (accel/ao.stratum_directions, the dense kernel's f32 formulas, which
  are `_stratified_dirs`' too), drawn from its own two uniforms: column
  j of the (2, B) jitter belongs to raster lane j, not to a compacted
  slot as on the dense accel;
- origins are ordered by accel/ao.compaction_order's Morton branch
  (hit lanes first, by normal octant and Morton cell), the strata
  permuted into cone-adjacent runs of K (`stratum_tile_perm`), and the
  S x B gather rays laid out as (origin group, stratum run, k, g): one
  warp of 32 rays is G = 32 / K neighbouring origins x K strata of one
  narrow cone (lucille_tpu groups 256 / K origins for its 256- or
  512-lane blocks; the answer does not depend on the grouping, only the
  speed does);
- missed lanes are parked outside the scene bounds, pointing away, so
  their rays leave at the root;
- the tile-BVH any-hit (accel/bvh_isect.py) traces the rays, and the
  occluded strata are summed per lane and scattered back to raster order;
- under a sunsky light (`bvh_ao_sunsky`, pallas_bvh.py:1236-1268) the
  same rays' visibility weights the sky radiance along each direction
  instead, summed per lane the same way.

Nothing here waits on the device: the live-lane count never leaves it,
so the renderer can enqueue every tile before it pulls the first.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lucille_tpu_torch.accel.ao import compaction_order, stratum_directions
from lucille_tpu_torch.accel.bvh_isect import WARP
from lucille_tpu_torch.accel.dispatch import any_hit

CONE_K = 4  # strata per warp: lucille_tpu's measured default (_cone_k)
MORTON_TILES = 1 << 20  # selects compaction_order's Morton branch


def stratum_tile_perm(ntheta: int, nphi: int, K: int) -> np.ndarray:
    """Permutation of the S strata into runs of K cone-adjacent (theta,
    phi) cells (pallas_bvh.py:1112-1131); the natural order when the
    grid does not tile evenly."""
    S = ntheta * nphi
    kt = max(1, int(np.sqrt(K)))
    while kt > 1 and (ntheta % kt or K % kt or nphi % (K // kt)):
        kt -= 1
    kp = K // kt
    if ntheta % kt or nphi % kp:
        return np.arange(S, dtype=np.int32)
    perm = []
    for jt in range(nphi // kp):
        for it in range(ntheta // kt):
            for jj in range(kp):
                for ii in range(kt):
                    perm.append((it * kt + ii) + ntheta * (jt * kp + jj))
    return np.asarray(perm, dtype=np.int32)


@lru_cache(maxsize=None)
def _device_consts(ntheta: int, nphi: int, K: int, dev: torch.device):
    """The stratum permutation and the parked direction, on `dev` once."""
    perm = torch.from_numpy(stratum_tile_perm(ntheta, nphi, K)).long()
    return perm.to(dev), torch.tensor([0.0, 0.0, -1.0], device=dev)


def cone_layout(S: int, B: int):
    """(K strata, G origins) per warp, and B padded to whole origin
    groups."""
    K = CONE_K
    while K > 1 and S % K:
        K //= 2
    G = WARP // K
    return K, G, -(-B // G) * G


def conetile_rays(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                  nphi: int):
    """The gather rays (pallas_bvh.py:1180-1233).  Returns (origins
    (S*Bpad, 3), directions (S*Bpad, 3), origin order (Bpad,) i64,
    layout (NG, S, G, Bpad)); flat ray index ((n * S) + s') * G + g is
    sorted origin n * G + g at permuted stratum s'."""
    B = P_off.shape[0]
    S = ntheta * nphi
    K, G, Bpad = cone_layout(S, B)
    if Bpad != B:
        def pad(a, dim=0):
            shape = list(a.shape)
            shape[dim] = Bpad - B
            return torch.cat([a, a.new_zeros(shape)], dim=dim)

        P_off, b0, b1, b2, hit = (pad(a) for a in (P_off, b0, b1, b2, hit))
        jitter = pad(jitter, dim=1)
    order, _nhit = compaction_order(scene.bbox_min, scene.bbox_max, P_off,
                                    b2, hit, MORTON_TILES)
    d_all = stratum_directions(b0, b1, b2, jitter, ntheta, nphi)
    diag = scene.bbox_max - scene.bbox_min
    o = torch.where(hit[:, None], P_off, (scene.bbox_min - diag - 1.0)[None])
    perm, away = _device_consts(ntheta, nphi, K, P_off.device)
    d_all = torch.where(hit[None, :, None], d_all, away)
    d_s = d_all[perm][:, order]
    NG = Bpad // G
    dd = (d_s.reshape(S // K, K, NG, G, 3).permute(2, 0, 1, 3, 4)
          .reshape(S * Bpad, 3))
    oo = (o[order].reshape(NG, 1, G, 3).expand(NG, S, G, 3)
          .reshape(S * Bpad, 3))
    return oo, dd, order, (NG, S, G, Bpad)


def bvh_ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                     nphi: int):
    """Occlusion counts for a wavefront of primary hits on a pbvh scene.

    P_off, b0, b1, b2: (B, 3) f32 offset shading points and orthonormal
    basis (b2 = shading normal); hit: (B,) bool; jitter: (2, B) f32
    uniforms, column j belonging to raster lane j.  Returns ((B,) f32
    occluded-strata counts, 0 where not hit; {ntrav, ntests} of the
    gather rays)."""
    B = P_off.shape[0]
    if tuple(jitter.shape) != (2, B) or jitter.dtype != torch.float32:
        raise ValueError(f"jitter: need (2, {B}) f32, got "
                         f"{tuple(jitter.shape)} {jitter.dtype}")
    if ntheta < 1 or nphi < 1:
        raise ValueError(f"ntheta, nphi must be >= 1, got {ntheta}, {nphi}")
    oo, dd, order, (NG, S, G, Bpad) = conetile_rays(
        scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi)
    res = any_hit(scene, oo, dd)
    occ_g = res["occ"].to(torch.float32).reshape(NG, S, G).sum(dim=1)
    occ = torch.empty(Bpad, dtype=torch.float32, device=P_off.device)
    occ[order] = occ_g.reshape(-1)
    stats = {"ntrav": res["ntrav"], "ntests": res["ntests"]}
    return occ[:B] * hit.to(torch.float32), stats


def bvh_ao_sunsky(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                  nphi: int, sky):
    """Sky radiance summed over each lane's unoccluded strata on a pbvh
    scene (pallas_bvh_ao_sunsky): the cone-tiled gather rays of
    bvh_ao_occlusion through the tile-BVH any-hit, vis x sky.sky_rgb of
    the direction in the sky's z-up frame (the reference's y/z swap,
    lightsource.c:152-155), summed over a lane's strata.  Operands as
    bvh_ao_occlusion; sky: lights/sunsky.PreethamSunSky.  Returns (B, 3)
    f32, 0 where not hit.  lucille_tpu drops this gather's counters
    (transport/ao.py:227-229); so does the port."""
    B = P_off.shape[0]
    oo, dd, order, (NG, S, G, Bpad) = conetile_rays(
        scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi)
    vis = ~any_hit(scene, oo, dd)["occ"]
    sky_rgb = sky.sky_rgb(dd[:, [0, 2, 1]])
    col_g = (vis[:, None] * sky_rgb).reshape(NG, S, G, 3).sum(dim=1)
    col = torch.empty((Bpad, 3), dtype=torch.float32, device=P_off.device)
    col[order] = col_g.reshape(-1, 3)
    return col[:B] * hit[:, None].to(torch.float32)
