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

lucille_tpu's own switch picks the gather, read at call time as
pallas_bvh.py:1001 reads it: ``LUCILLE_BVH_AO`` unset or "cone" runs the
cone-tiled gather above, "rebinned" the re-binned gather
(`bvh_ao_rebinned`, pallas_bvh.py:1062-1110, which lucille_tpu measured
slower and keeps for measurement, :982-994):

- every hit lane's S directions from the same (2, B) draw as the cone
  gather's, column j belonging to raster lane j (`_stratified_dirs`,
  :1018-1050), all S x B rays at once, missed lanes parked as above;
- the rays sorted by a 31-bit key, direction octant | 3-bit direction
  Morton | 6-bit origin Morton (parked rays last), traced in that order
  by the tile-BVH any-hit (kernel 5), scattered back and summed over the
  strata; the order among equal keys changes no answer, and the gather
  reports no counters (:1006);

and any other value runs the fused gather (`bvh_ao_fused`, kernel 6,
pallas_bvh.py:810 `_bvh_ao_kernel` behind `_pallas_bvh_ao_occlusion`):

- hit lanes compacted by compaction_order's Morton branch, column j of
  the (2, B) jitter belonging to compacted slot j (as on the dense
  accel; the draw is the same (2, B) draw as the cone gather's);
- for each live slot and stratum, the stratified direction built in the
  kernel from the slot's basis and jitter (stratum_directions' f32
  formulas) and an unbounded any-hit walk of the tile BVH with the
  signed-volume test; the count of occluded strata, scattered back to
  raster order (0 where not hit);
- csrc/bvh.cu's `bvh_ao_kernel` for CUDA tensors (kernel 5's warp walk,
  each lane's ray built in registers), `bvh_ao_fused_reference` (every
  stratum of every live slot against every triangle) for CPU tensors.
  Its counters are the warp walk's (isect.walk_stats): ntrav = node
  visits summed over the (slot, stratum) lanes that reach the node,
  ntests = real triangles tested, and the warps' own warp_ntrav and
  warp_ntests; the twin visits no node and tests every slot.

Nothing here waits on the device: the live-lane count never leaves it,
so the renderer can enqueue every tile before it pulls the first.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from lucille_tpu_torch.accel.ao import (
    _spread3,
    compaction_order,
    stratum_directions,
    to_raster,
)
from lucille_tpu_torch.accel.bvh_isect import (
    STACK,
    WARP,
    check_leaf_real,
    occlusion_scan,
)
from lucille_tpu_torch.accel.dispatch import any_hit
from lucille_tpu_torch.accel.isect import NSTAT, walk_stats
from lucille_tpu_torch.accel.pack import TC
from lucille_tpu_torch.base.timer import traced
from lucille_tpu_torch.kernels.build import LaunchCounts, check, library

CONE_K = 4  # strata per warp: lucille_tpu's measured default (_cone_k)
MORTON_TILES = 1 << 20  # selects compaction_order's Morton branch
FUSED_WARPS = 8  # the fused gather's most warps per block (csrc/bvh.cu)

FUSED_COUNTS = LaunchCounts()  # the fused gather (kernel 6)


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
    return perm.to(dev), _away(dev)


@lru_cache(maxsize=None)
def _away(dev: torch.device) -> torch.Tensor:
    """The parked rays' direction (0, 0, -1), on `dev` once."""
    return torch.tensor([0.0, 0.0, -1.0], device=dev)


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


def gather_mode() -> str:
    """lucille_tpu's LUCILLE_BVH_AO switch, read at call time: "cone" (the
    default), "rebinned" or "fused" (any other value)."""
    mode = os.environ.get("LUCILLE_BVH_AO", "cone")
    return mode if mode in ("cone", "rebinned") else "fused"


def _check_gather(B, jitter, ntheta, nphi):
    if tuple(jitter.shape) != (2, B) or jitter.dtype != torch.float32:
        raise ValueError(f"jitter: need (2, {B}) f32, got "
                         f"{tuple(jitter.shape)} {jitter.dtype}")
    if ntheta < 1 or nphi < 1:
        raise ValueError(f"ntheta, nphi must be >= 1, got {ntheta}, {nphi}")


def bvh_ao_occlusion(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                     nphi: int):
    """Occlusion counts for a wavefront of primary hits on a pbvh scene,
    by the gather LUCILLE_BVH_AO selects (`gather_mode`).

    P_off, b0, b1, b2: (B, 3) f32 offset shading points and orthonormal
    basis (b2 = shading normal); hit: (B,) bool; jitter: (2, B) f32
    uniforms, column j belonging to raster lane j (cone, rebinned) or to
    compacted slot j (fused).  Returns ((B,) f32 occluded-strata counts, 0
    where not hit; {ntrav, ntests} of the gather's walks, none for the
    re-binned gather)."""
    B = P_off.shape[0]
    _check_gather(B, jitter, ntheta, nphi)
    mode = gather_mode()
    if mode == "fused":
        return bvh_ao_fused(scene, P_off, b0, b1, b2, hit, jitter, ntheta,
                            nphi)
    if mode == "rebinned":
        return bvh_ao_rebinned(scene, P_off, b0, b1, b2, hit, jitter, ntheta,
                               nphi), {}
    oo, dd, order, (NG, S, G, Bpad) = conetile_rays(
        scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi)
    res = any_hit(scene, oo, dd)
    occ_g = res["occ"].to(torch.float32).reshape(NG, S, G).sum(dim=1)
    occ = to_raster(order, occ_g.reshape(-1))
    stats = {"ntrav": res["ntrav"], "ntests": res["ntests"]}
    return occ[:B] * hit.to(torch.float32), stats


def bvh_ao_rebinned(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                    nphi: int) -> torch.Tensor:
    """The re-binned gather (module docstring; pallas_bvh.py:1062-1110):
    operands as bvh_ao_occlusion, jitter column j belonging to raster
    lane j.  Returns (B,) f32 occluded-strata counts, 0 where not hit."""
    B = P_off.shape[0]
    S = ntheta * nphi
    d = stratum_directions(b0, b1, b2, jitter, ntheta, nphi).reshape(S * B, 3)
    o = P_off[None].expand(S, B, 3).reshape(S * B, 3)
    live = hit[None].expand(S, B).reshape(S * B)
    bmin, bmax = scene.bbox_min, scene.bbox_max
    o = torch.where(live[:, None], o, (bmin - (bmax - bmin) - 1.0)[None])
    d = torch.where(live[:, None], d, _away(P_off.device))
    octant = ((d[:, 0] > 0).to(torch.int32) * 4
              + (d[:, 1] > 0).to(torch.int32) * 2
              + (d[:, 2] > 0).to(torch.int32))
    qd = ((d * 0.5 + 0.5) * 8.0).to(torch.int32).clamp(0, 7)
    md = ((_spread3(qd[:, 0]) << 2) | (_spread3(qd[:, 1]) << 1)
          | _spread3(qd[:, 2]))
    ext = torch.clamp_min(bmax - bmin, 1e-12)
    qo = ((o - bmin) / ext * 64.0).to(torch.int32).clamp(0, 63)
    mo = ((_spread3(qo[:, 0]) << 2) | (_spread3(qo[:, 1]) << 1)
          | _spread3(qo[:, 2]))
    key = torch.where(live, (octant << 27) | (md << 18) | mo,
                      torch.full_like(mo, 1 << 30))
    order = torch.argsort(key)
    occ_sorted = any_hit(scene, o[order], d[order])["occ"]
    occ = to_raster(order, occ_sorted.to(torch.float32))
    return occ.reshape(S, B).sum(dim=0) * hit.to(torch.float32)


def bvh_ao_sunsky(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                  nphi: int, sky):
    """Sky radiance summed over each lane's unoccluded strata on a pbvh
    scene (pallas_bvh_ao_sunsky): the cone-tiled gather rays of
    bvh_ao_occlusion through the tile-BVH any-hit, vis x
    sky.sky_rgb_world of the direction (the sky applies the reference's
    y/z swap, lightsource.c:152-155), summed over a lane's strata.
    Operands as bvh_ao_occlusion; sky: lights/sunsky.PreethamSunSky.
    Returns (B, 3) f32, 0 where not hit.  lucille_tpu drops this
    gather's counters (transport/ao.py:227-229); so does the port."""
    B = P_off.shape[0]
    oo, dd, order, (NG, S, G, Bpad) = conetile_rays(
        scene, P_off, b0, b1, b2, hit, jitter, ntheta, nphi)
    vis = ~any_hit(scene, oo, dd)["occ"]
    sky_rgb = sky.sky_rgb_world(dd)
    col_g = (vis[:, None] * sky_rgb).reshape(NG, S, G, 3).sum(dim=1)
    col = to_raster(order, col_g.reshape(-1, 3))
    return col[:B] * hit[:, None].to(torch.float32)


def bvh_ao_fused(scene, P_off, b0, b1, b2, hit, jitter, ntheta: int,
                 nphi: int):
    """The fused gather (kernel 6; module docstring).  Operands and
    result as bvh_ao_occlusion, with jitter column j belonging to
    compacted slot j."""
    B = P_off.shape[0]
    _check_gather(B, jitter, ntheta, nphi)
    order, nhit = compaction_order(scene.bbox_min, scene.bbox_max, P_off, b2,
                                   hit, MORTON_TILES)
    rays = torch.cat([P_off, b0, b1, b2], dim=1)[order].T.contiguous()
    jitter = jitter.contiguous()
    tris = scene.tris
    dev = P_off.device
    if dev.type == "cuda":
        occ_s, stats = bvh_ao_fused_kernel(tris, scene.nodes,
                                           scene.leaf_real, rays, jitter,
                                           nhit, ntheta, nphi,
                                           depth=scene.tree_depth)
    elif dev.type == "cpu":
        n = int(nhit)
        occ_s = torch.zeros(B, device=dev)
        occ_s[:n], stats = bvh_ao_fused_reference(
            tris, rays[:, :n], jitter[:, :n], ntheta, nphi)
    else:
        raise ValueError(f"unsupported device {dev}")
    return to_raster(order, occ_s), stats


def fused_layout(S: int):
    """(K strata per warp, warps per block) of the fused kernel: K as the
    cone gather's (cone_layout), at most FUSED_WARPS warps of K x (32 / K)
    (slot, stratum) walks each."""
    K = cone_layout(S, 1)[0]
    return K, min(S // K, FUSED_WARPS)


@traced("accel.bvh_ao_fused_kernel")
def bvh_ao_fused_kernel(tris, nodes, leaf_real, rays, jitter, nact,
                        ntheta: int, nphi: int, *, depth: int):
    """Launch csrc/bvh.cu's fused gather on the current stream (CUDA
    tensors only): the tree as bvh_isect.bvh_any_hit takes it (tris,
    nodes, leaf_real, depth); rays (12, B) [P_off | b0 | b1 | b2] and
    jitter (2, B) in compacted order, nact () i32 live slots on the
    device (slots at or past it report 0).  Returns ((B,) f32 counts in
    compacted order, the walk's counters () i64)."""
    B = rays.shape[1]
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for name, a in (("tris", tris), ("nodes", nodes), ("rays", rays),
                    ("jitter", jitter)):
        if a.dtype != torch.float32 or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: need contiguous float32 on {dev}")
    if tris.shape[0] != 16 or tris.shape[1] % TC:
        raise ValueError(f"tris: need (16, k*{TC}), got {tuple(tris.shape)}")
    if nodes.dim() != 2 or nodes.shape[1] != 8:
        raise ValueError(f"nodes: need (M, 8), got {tuple(nodes.shape)}")
    check_leaf_real(leaf_real, nodes)
    if depth > STACK:
        raise ValueError(f"tree depth {depth} exceeds the kernel's "
                         f"{STACK}-entry stack")
    if rays.shape[0] != 12 or tuple(jitter.shape) != (2, B):
        raise ValueError(f"rays {tuple(rays.shape)} / jitter "
                         f"{tuple(jitter.shape)} mismatch")
    if nact.dtype != torch.int32 or nact.numel() != 1 or nact.device != dev:
        raise ValueError("nact: need one int32 on the rays' device")
    S = ntheta * nphi
    K, warps = fused_layout(S)
    G = WARP // K
    perm = _device_consts(ntheta, nphi, K, dev)[0].to(torch.int32)
    occ = torch.empty(B, dtype=torch.float32, device=dev)
    stats = torch.empty(NSTAT * -(-B // G), dtype=torch.int32, device=dev)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lt_bvh_ao_fused(
            rays.data_ptr(), jitter.data_ptr(), B, nact.data_ptr(),
            tris.data_ptr(), tris.shape[1], nodes.data_ptr(),
            leaf_real.data_ptr(), perm.data_ptr(), S, K, warps, ntheta,
            1.0 / ntheta, 1.0 / nphi, occ.data_ptr(), stats.data_ptr(),
            stream,
        )
    check("lt_bvh_ao_fused", err)
    FUSED_COUNTS.kernel += 1
    return occ, walk_stats(stats)


@traced("accel.bvh_ao_fused_reference")
def bvh_ao_fused_reference(tris, rays, u01, ntheta: int, nphi: int,
                           lane_chunk: int = 4096):
    """Plain torch twin of the fused gather for slots that all hit: rays
    (12, n) [P_off | b0 | b1 | b2], u01 (2, n) each slot's own uniforms.
    Every stratum's direction (stratum_directions) against every
    triangle with the kernel's unbounded signed-volume test
    (bvh_isect.occlusion_scan).  Returns ((n,) f32 occluded-strata
    counts, {ntrav 0, ntests: every slot for every walk})."""
    FUSED_COUNTS.plain += 1
    n = rays.shape[1]
    S = ntheta * nphi
    dev = rays.device
    occ = torch.zeros(n, device=dev)
    for lo in range(0, n, lane_chunk):
        hi = min(n, lo + lane_chunk)
        P = rays[0:3, lo:hi].T
        dirs = stratum_directions(*(rays[3 * c : 3 * c + 3, lo:hi].T
                                    for c in (1, 2, 3)),
                                  u01[:, lo:hi], ntheta, nphi)
        o = P[None].expand(S, hi - lo, 3).reshape(-1, 3)
        hits = occlusion_scan(tris, o, dirs.reshape(-1, 3).contiguous())
        occ[lo:hi] = hits.reshape(S, hi - lo).sum(dim=0).to(torch.float32)
    stats = {"ntrav": torch.zeros((), dtype=torch.int64, device=dev),
             "ntests": torch.tensor(n * S * tris.shape[1], dtype=torch.int64,
                                    device=dev)}
    return occ, stats
