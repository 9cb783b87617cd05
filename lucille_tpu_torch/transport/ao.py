"""Ambient-occlusion integrator, in torch.

Counterpart of lucille_tpu/transport/ao.py:35-283 and :335-376: eye ray
-> closest hit -> interpolated shading normal, Frisvad basis, eps-offset
origin -> stratified occlusion gather -> ``Lo = (S - occluded) / S``
modulated by the interpolated vertex colour and, where the material
binds one, its texture at the hit's st (`_modulate`); misses return the
background.  The gather is chosen in accel/gather.py by lucille_tpu's rule
(ao.py:136-171): the fused dense gather (csrc/ao.cu) up to
MAX_TRIS_FOR_MEGAKERNEL padded triangles, the tile BVH's gather on pbvh
(csrc/bvh.cu; its node visits and triangle tests join the eye rays'
counters), and otherwise a scan over the strata through the any-hit.

Under a sunsky light the gather is the reference's sunsky AO
(`_gather_sunsky`, ambientocclusion.c:154-332): the Preetham sky
radiance summed over each lane's unoccluded strata
(accel/gather.sky_radiance), plus, per "sun" light, one shadow ray toward
the sun (the dense any-hit, or the tile BVH's) that adds the sun's colour
where it is open; ``Lo = col / (pi S)``, then the same modulation.

The gather's jitter is drawn from the tile's random stream
(sampling/jitter.py) at the tile's own key, StreamKey(stream), as
lucille_tpu draws it from its tile key; the same draws for plain and
sunsky AO (accel/gather.py says which).  Norms and sums are written as
explicit left-to-right products so they round as the JAX package's do.
"""

from __future__ import annotations

import math

import torch

from lucille_tpu_torch.accel import gather
from lucille_tpu_torch.accel.dispatch import any_hit, closest_hit
from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.ops.frame import norm, ortho_basis
from lucille_tpu_torch.sampling.jitter import StreamKey


def _interp_normal(scene, res) -> torch.Tensor:
    """Barycentric vertex-normal interpolation at the hits, normalized."""
    tri = torch.clamp_min(res["tri"], 0).long()
    u = res["u"][..., None]
    v = res["v"][..., None]
    n = (1.0 - u - v) * scene.n0[tri] + u * scene.n1[tri] + v * scene.n2[tri]
    return n / torch.clamp_min(norm(n), 1e-20)


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
    occ, walks = gather.occlusion(scene, P_off, b0, b1, b2, hit,
                                  StreamKey(stream), ntheta, nphi)
    return _finish(scene, res, hit, occ, ntheta * nphi, background, B,
                   walks, textures)


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
    col = gather.sky_radiance(scene, P_off, b0, b1, b2, hit,
                              StreamKey(stream), ntheta, nphi, sky)
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
            walks: dict, textures=None):
    """Occlusion count -> radiance, plus the counters.  nrays counts an eye
    ray for every lane and S gather rays for every hit (raytrace.c:43);
    `walks` adds the gather rays' ntests/ntrav to the eye rays'.
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
        "ntests": res["ntests"] + walks.get("ntests", 0),
        "ntrav": res["ntrav"] + walks.get("ntrav", 0),
        "t": res["t"],
    }
    return radiance, aux
