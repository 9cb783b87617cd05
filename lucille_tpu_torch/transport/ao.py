"""Ambient-occlusion integrator, in torch.

Counterpart of lucille_tpu/transport/ao.py:35-283 and :335-376: eye ray
-> closest hit -> interpolated shading normal, Frisvad basis, eps-offset
origin -> stratified occlusion gather -> ``Lo = (S - occluded) / S``
modulated by the interpolated vertex colour and, where the material
binds one, its texture at the hit's st (`_modulate`); misses return the
background.  The accel picks the kernels, as lucille_tpu/transport/
ao.py:136-171 does:

- dense: the dense closest hit (csrc/isect.cu) and the fused gather
  (csrc/ao.cu) up to MAX_TRIS_FOR_MEGAKERNEL padded triangles; above
  it, as lucille_tpu (ao.py:173-195), a scan over the strata, each
  stratum's rays, with their own jitter, through the dense any-hit
  (`_scan_occlusion`);
- pbvh: the tile-BVH closest hit and the cone-tiled gather through the
  tile-BVH any-hit (csrc/bvh.cu); the gather's node visits and triangle
  tests join the eye rays' counters;
- lucille_tpu's "bruteforce" and "mxu" on the dense tiles, and the grid
  (csrc/ugrid.cu): the scan over the strata, as lucille_tpu scans for
  any accel but "pallas" and "pbvh" (`gather_kind`).

Under a sunsky light the gather is the reference's sunsky AO
(`_gather_sunsky`, ambientocclusion.c:154-332): the Preetham sky
radiance summed over each lane's unoccluded strata, plus, per "sun"
light, one shadow ray toward the sun (the dense any-hit, or the tile
BVH's) that adds the sun's colour where it is open; ``Lo = col / (pi
S)``, then the same modulation.  On the dense accel the fused gather's
per-stratum bits say which strata are open and the directions are
recomputed with the kernel's formula (`accel/ao.ao_sunsky`: the sky
summed over them in csrc/ao.cu's sky_gather_kernel), or, above the
threshold, the strata are scanned (`_scan_sunsky`, lucille_tpu's
ao.py:230-257); on the tile BVH the cone-tiled gather rays carry the sky
directly (`bvh_ao_sunsky`).

The per-lane jitter is the tile's own draw from its random stream
(sampling/jitter.py), stream.uniform((), (2, B)), as lucille_tpu's is
uniform(key, (2, B)); the same draw for plain and sunsky AO.  On the
dense accel column j belongs to compacted hit slot j (the fused kernel's
lane order); on the tile BVH it belongs to raster lane j, because
lucille_tpu's `_stratified_dirs` draws its (2, B) uniforms on the
unsorted wavefront.  The scans draw stream.uniform((si,), (B, 2)) for
stratum si, as lucille_tpu draws uniform(fold_in(key, si), (B, 2)).
Norms and sums are written as explicit left-to-right products so they
round as the JAX package's do.
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
from lucille_tpu_torch.accel.dispatch import any_hit, closest_hit
from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.lights.sunsky import sky_frame


def _norm(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis (size 3), keepdim, summed left to right."""
    return torch.sqrt(x[..., 0:1] * x[..., 0:1] + x[..., 1:2] * x[..., 1:2]
                      + x[..., 2:3] * x[..., 2:3])


def ortho_basis(n: torch.Tensor):
    """Branchless Frisvad/Duff frame (b0, b1, n) for unit normals (B, 3),
    continuous in n except at n = (0, 0, -1)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = torch.clamp(-1.0 / (s + nz), -1e3, 1e3)
    b = nx * ny * a
    b0 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    b1 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    b0 = b0 / torch.clamp_min(_norm(b0), 1e-20)
    b1 = b1 / torch.clamp_min(_norm(b1), 1e-20)
    return b0, b1, n


def _interp_normal(scene, res) -> torch.Tensor:
    """Barycentric vertex-normal interpolation at the hits, normalized."""
    tri = torch.clamp_min(res["tri"], 0).long()
    u = res["u"][..., None]
    v = res["v"][..., None]
    n = (1.0 - u - v) * scene.n0[tri] + u * scene.n1[tri] + v * scene.n2[tri]
    return n / torch.clamp_min(_norm(n), 1e-20)


def ao_radiance(scene, org, dirn, stream, ntheta: int, nphi: int,
                background: float = 0.0, lights=(), textures=None):
    """AO radiance for a wavefront of eye rays org, dirn (B, 3) f32 with
    the tile's random stream.  lights: the light tables
    (lights/tables.py); a "sunsky" light with a sky model switches to the
    sunsky gather, "sun" lights join it.  textures: the renderer's
    texture atlas, or None.  Returns (radiance (B, 3), aux
    with hit mask, t and the counters)."""
    B = org.shape[0]
    res = closest_hit(scene, org, dirn)
    P_off, b0, b1, b2 = shading_frame(scene, org, dirn, res)
    hit = res["hit"]
    sunsky = next((li for li in lights
                   if li.type == "sunsky" and li.sunsky is not None), None)
    if sunsky is not None:
        suns = [li for li in lights if li.type == "sun"]
        return _gather_sunsky(scene, res, hit, P_off, b0, b1, b2, stream,
                              ntheta, nphi, sunsky.sunsky, suns, background,
                              B, textures)
    gather = {}
    kind = gather_kind(scene)
    if kind == "bvh":
        occ, gather = bvh_ao_occlusion(scene, P_off, b0, b1, b2, hit,
                                       stream.uniform((), (2, B)), ntheta,
                                       nphi)
    elif kind == "scan":
        occ = _scan_occlusion(scene, P_off, b0, b1, b2, hit, stream, ntheta,
                              nphi)
    else:
        occ = ao_occlusion(scene, P_off, b0, b1, b2, hit,
                           stream.uniform((), (2, B)), ntheta, nphi)
    return _finish(scene, res, hit, occ, ntheta * nphi, background, B,
                   gather, textures)


def shading_frame(scene, org, dirn, res):
    """The gather's inputs at the eye hits: eps-offset shading point and
    the orthonormal basis (b0, b1, b2 = shading normal), each (B, 3)."""
    t = torch.where(res["hit"], res["t"], 0.0)
    P = org + t[..., None] * dirn
    Ns = _interp_normal(scene, res)
    b0, b1, b2 = ortho_basis(Ns)
    return P + Ns * scene.eps, b0, b1, b2


def _modulate(scene, res, hit, radiance, textures=None):
    """Vertex-colour and material-texture modulation at the hit
    (ambientocclusion.c:393-400; lucille_tpu/transport/ao.py:335-352)."""
    tri = torch.clamp_min(res["tri"], 0).long()
    u = res["u"][..., None]
    v = res["v"][..., None]
    w = 1.0 - u - v
    cs = w * scene.c0[tri] + u * scene.c1[tri] + v * scene.c2[tri]
    radiance = radiance * torch.where(hit[..., None], cs, 1.0)
    if textures is not None and textures.data is not None:
        st = w * scene.st0[tri] + u * scene.st1[tri] + v * scene.st2[tri]
        tex_id = scene.mat_texture[scene.geom_id[tri].long()]
        texcol = textures.fetch(torch.clamp_min(tex_id, 0), st[..., 0],
                                st[..., 1])
        has_tex = hit & (tex_id >= 0)
        radiance = radiance * torch.where(has_tex[..., None], texcol, 1.0)
    return radiance


def gather_kind(scene) -> str:
    """Which gather serves the scene's AO and dome strata, by lucille_tpu's
    rule (transport/ao.py:136-148, :209-215; lights/sampling.py:83-95):
    "fused-dense", kernel 3's fused gather, for its "pallas" request up
    to MAX_TRIS_FOR_MEGAKERNEL padded triangles; "bvh", the tile BVH's
    gather, for "pbvh"; "scan", the strata through the any-hit, for
    everything else (the dense tiles above the threshold, "bruteforce",
    "mxu" and the grid)."""
    if scene.accel == "pbvh":
        return "bvh"
    if (scene.intersector == "pallas"
            and scene.tri_v0.shape[0] <= MAX_TRIS_FOR_MEGAKERNEL):
        return "fused-dense"
    return "scan"


def _scan_dirs(b0, b1, b2, ur, si: int, ntheta: int, nphi: int):
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


def _scan_occlusion(scene, P_off, b0, b1, b2, hit, stream, ntheta: int,
                    nphi: int):
    """Occluded-strata counts (B,) f32, 0 where not hit, by the dense scan
    (lucille_tpu/transport/ao.py:173-195): stratum si's rays, with the
    jitter stream.uniform((si,), (B, 2)), through the dense any-hit (kernel
    2 on the card), each stratum launched without a host sync."""
    B = P_off.shape[0]
    occ = torch.zeros(B, dtype=torch.float32, device=P_off.device)
    for si in range(ntheta * nphi):
        wdir = _scan_dirs(b0, b1, b2, stream.uniform((si,), (B, 2)), si,
                          ntheta, nphi)
        occ = occ + any_hit(scene, P_off, wdir, active=hit)["occ"].to(
            torch.float32)
    return occ


def _scan_sunsky(scene, P_off, b0, b1, b2, hit, stream, ntheta: int,
                 nphi: int, sky):
    """Sky radiance (B, 3) over each hit lane's open strata by the dense
    scan (lucille_tpu/transport/ao.py:230-257): the strata and jitter of
    `_scan_occlusion`, the sky along each open direction in its z-up
    frame."""
    B = P_off.shape[0]
    col = torch.zeros((B, 3), dtype=torch.float32, device=P_off.device)
    for si in range(ntheta * nphi):
        wdir = _scan_dirs(b0, b1, b2, stream.uniform((si,), (B, 2)), si,
                          ntheta, nphi)
        vis = ~any_hit(scene, P_off, wdir, active=hit)["occ"] & hit
        col = col + vis[:, None] * sky.sky_rgb(sky_frame(wdir))
    return col


def _gather_sunsky(scene, res, hit, P_off, b0, b1, b2, stream, ntheta,
                   nphi, sky, suns, background: float, B: int,
                   textures=None):
    """Sunsky-AO gather (lucille_tpu/transport/ao.py:198-283): sky
    radiance over the unoccluded strata, one shadow ray toward each sun
    along +direction adding its colour unattenuated (no cosine,
    contribution_from_sunlight), Lo = col / (pi S).  nrays counts an eye
    ray per lane and S + len(suns) rays per hit (ao.py:275-277); the
    gather's own counters are dropped, as lucille_tpu drops them."""
    S = ntheta * nphi
    kind = gather_kind(scene)
    if kind == "bvh":
        col = bvh_ao_sunsky(scene, P_off, b0, b1, b2, hit,
                            stream.uniform((), (2, B)), ntheta, nphi, sky)
    elif kind == "scan":
        col = _scan_sunsky(scene, P_off, b0, b1, b2, hit, stream, ntheta,
                           nphi, sky)
    else:
        col = ao_sunsky(scene, P_off, b0, b1, b2, hit,
                        stream.uniform((), (2, B)), ntheta, nphi, sky)
    for sun in suns:
        wi = const_vec(sun.direction, P_off.device)
        wi = wi / torch.clamp_min(torch.sqrt(torch.sum(wi * wi)), 1e-20)
        occ = any_hit(scene, P_off, wi.expand_as(P_off), active=hit)["occ"]
        suncol = const_vec(sun.color, P_off.device) * sun.intensity
        col = col + ((~occ) & hit).to(torch.float32)[:, None] * suncol
    lo = col / (math.pi * S)
    radiance = _modulate(scene, res, hit,
                         torch.where(hit[..., None], lo, background),
                         textures)
    aux = {
        "hit": hit,
        "nrays": B + hit.sum(dtype=torch.int64) * (S + len(suns)),
        "ntests": res["ntests"],
        "ntrav": res["ntrav"],
        "t": res["t"],
    }
    return radiance, aux


def _finish(scene, res, hit, occ, nsamples: int, background: float, B: int,
            gather: dict, textures=None):
    """Occlusion count -> radiance, plus the counters.  nrays counts an eye
    ray for every lane and S gather rays for every hit (raytrace.c:43);
    `gather` adds the gather rays' ntests/ntrav to the eye rays'.
    lucille_tpu's nmiss (tile-cache misses) is 0 by definition in the
    port, which keeps no tile cache (accel/bvh_isect.py), so it is not
    carried."""
    lo = (nsamples - occ) / nsamples
    radiance = torch.where(hit, lo, background)[..., None] * torch.ones(
        (1, 3), dtype=torch.float32, device=occ.device
    )
    radiance = _modulate(scene, res, hit, radiance, textures)
    aux = {
        "hit": hit,
        "nrays": B + hit.sum(dtype=torch.int64) * nsamples,
        "ntests": res["ntests"] + gather.get("ntests", 0),
        "ntrav": res["ntrav"] + gather.get("ntrav", 0),
        "t": res["t"],
    }
    return radiance, aux
