"""Direct-lighting estimators over the light tables, in torch.

Counterpart of lucille_tpu/lights/sampling.py (the reference's light
sampling, light.h:73-100, shader.c's diffuse() and specular() built-ins,
shader.c:504-633, and ibl.c's environment samplers): wavefront functions of shading
points P and normals N (B, 3), one shadow wavefront per light sample,
the per-light loop unrolled in Python.  Random numbers come from a
`sampling/jitter.StreamKey` where lucille_tpu takes a `jax.random` key,
folded at the same places.

A constant dome light's hemisphere visibility is the AO gather's job, as
in lucille_tpu (`_hemisphere_occlusion`), where a fused gather serves the
scene (accel/gather.fused_serves: the dense tiles' fused gather up to
131,072 padded triangles under lucille_tpu's "pallas" request, the tile
BVH's gather on pbvh scenes); anything else (the dense scan,
"bruteforce", "mxu", the grid) takes the cosine-weighted loop of shadow
rays, as in lucille_tpu.  A dome or IBL light with
an environment texture goes through the sampler its RIB selects
(`_env_contribution`, lights/ibl.py).  `light_wi_cl` is one (direction,
shadowed colour) sample of a light, the binding of RSL `illuminance`
blocks.
"""

from __future__ import annotations

import math

import torch

from lucille_tpu_torch.accel import gather
from lucille_tpu_torch.accel.dispatch import any_hit
from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.lights import ibl
from lucille_tpu_torch.lights.tables import (
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_DOME,
    LIGHT_IBL,
    LIGHT_POINT,
    LIGHT_SUN,
    LIGHT_SUNSKY,
)
from lucille_tpu_torch.ops.frame import (
    cosweight_sample,
    dot,
    norm,
    ortho_basis,
)

GATHER_LIGHTS = (LIGHT_DOME, LIGHT_AREA, LIGHT_SUNSKY, LIGHT_IBL)


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    return const_vec(x, like.device)


def light_color(light, like: torch.Tensor) -> torch.Tensor:
    """(3,) f32 colour x intensity."""
    return _vec(light.color, like) * light.intensity


def delta_direction(light, like: torch.Tensor) -> torch.Tensor:
    """The unit direction toward a distant or sun light, broadcast to
    like's (B, 3): a distant light stores the direction it shines (wi =
    -direction), a sunlight the direction toward the sun (+direction,
    lightsource.c:155-158)."""
    sgn = 1.0 if light.type == LIGHT_SUN else -1.0
    wi = sgn * _vec(light.direction, like)
    return (wi / torch.clamp_min(norm(wi), 1e-20)).expand(like.shape)


def occlusion(scene, org, wi, tmax=None, active=None) -> torch.Tensor:
    """(B,) f32 1 where the shadow ray is blocked (any_hit), else 0."""
    return any_hit(scene, org, wi, tmax, active)["occ"].to(torch.float32)


def _shadow(scene, P, N, wi, tmax=None, active=None) -> torch.Tensor:
    """(B,) f32 visibility of a shadow ray from P + N eps along wi."""
    return 1.0 - occlusion(scene, P + N * scene.eps, wi, tmax, active)


def sample_area_light(light, u: torch.Tensor):
    """Uniform points on an area light's triangles.  u: (B, 3) uniforms on
    the device of the light's tables (lights/tables.LightEntry.area) ->
    (points (B, 3), normals (B, 3), pdf_area (B,))."""
    tris = light.tris
    cdf, v0, e1, e2 = light.area
    # torch's right=False is jnp.searchsorted's default, side="left"
    ti = torch.clamp(torch.searchsorted(cdf, u[:, 0].contiguous()), 0,
                     len(cdf) - 1)
    # uniform barycentrics by the sqrt warp: b1 = 1 - sqrt(u1), b2 = u2 sqrt(u1)
    su = torch.sqrt(torch.clamp_min(u[:, 1], 1e-12))
    b1 = 1.0 - su
    b2 = u[:, 2] * su
    a, b = e1[ti], e2[ti]
    pts = v0[ti] + b1[:, None] * a + b2[:, None] * b
    nrm = torch.stack([
        a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
    ], dim=-1)
    nrm = nrm / torch.clamp_min(norm(nrm), 1e-20)
    pdf_area = 1.0 / max(tris["total_area"], 1e-20)
    return pts, nrm, torch.full((u.shape[0],), pdf_area, device=u.device)


def _hemisphere_occlusion(scene, P, N, key, nsamples: int, active):
    """Stratified hemisphere occlusion counts (B,) f32 through the AO
    gathers (module docstring), or None where no fused gather serves the
    scene or nsamples has no ntheta x nphi grid.  The gather's (2, B)
    jitter is key.uniform((2, B)), as the TPU gathers draw uniform(key,
    (2, B))."""
    if not gather.fused_serves(scene):
        return None
    nt = math.isqrt(nsamples)
    while nt > 1 and nsamples % nt:
        nt -= 1
    nph = nsamples // nt
    if nt * nph != nsamples:
        return None
    B = P.shape[0]
    hit = active if active is not None else torch.ones(
        B, dtype=torch.bool, device=P.device)
    b0, b1, b2 = ortho_basis(N)
    return gather.occlusion(scene, P + N * scene.eps, b0, b1, b2, hit, key,
                            nt, nph)[0]


def _cosweight_gather(scene, light, P, N, key, nsamples: int, active):
    """Cosine-weighted hemisphere gather (ibl.c:53's cosweight sampler):
    nsamples shadow rays, each weighted by pi (cos / pdf), the sky's
    radiance along it for a sunsky light, else the light's colour."""
    basis = ortho_basis(N)
    total = torch.zeros_like(P)
    col = light_color(light, P)
    for si in range(nsamples):
        ur = key.fold(si).uniform((P.shape[0], 2))
        wi, _pdf = cosweight_sample(ur[:, 0], ur[:, 1], basis)
        vis = _shadow(scene, P, N, wi, active=active)
        if light.type == LIGHT_SUNSKY and light.sunsky is not None:
            li = light.sunsky.sky_rgb_world(wi)
        else:
            li = col[None, :]
        total = total + vis[:, None] * li * math.pi
    return total / nsamples


def _area_geometry(light, P, u):
    """(wi, r, r2, cos_l, pdf_a) of one sample u (B, 3) on an area light."""
    pts, ln, pdf_a = sample_area_light(light, u)
    d = pts - P
    r2 = torch.clamp_min(dot(d, d)[:, 0], 1e-10)
    r = torch.sqrt(r2)
    wi = d / r[:, None]
    cos_l = torch.clamp_min(-dot(ln, wi)[:, 0], 0.0)
    return wi, r, r2, cos_l, pdf_a


def light_contribution(scene, light, P, N, key, nsamples: int = 1,
                       active=None) -> torch.Tensor:
    """Shadowed incident light of one light, E = Li cos / pdf, (B, 3).
    active: None or the (B,) live lanes; the shadow wavefronts trace
    those alone."""
    col = light_color(light, P)
    if light.type in (LIGHT_DISTANT, LIGHT_SUN):
        wi = delta_direction(light, P)
        cos = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
        return (cos * _shadow(scene, P, N, wi, active=active))[:, None] * col

    if light.type == LIGHT_POINT:
        d = _vec(light.position, P) - P
        r2 = torch.clamp_min(dot(d, d)[:, 0], 1e-12)
        r = torch.sqrt(r2)
        wi = d / r[:, None]
        cos = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
        # occluders beyond the light do not count
        vis = _shadow(scene, P, N, wi, r - 2.0 * scene.eps, active)
        return (cos * vis / r2)[:, None] * col

    if light.type in (LIGHT_DOME, LIGHT_IBL) and light.env is not None:
        # textured environment light: the sampler the RIB selected
        # (lightsource.c:127-142 tokens -> ibl.c:53-540)
        return _env_contribution(scene, light, P, N, key, nsamples, active)

    if light.type == LIGHT_DOME:
        # a constant dome's gather is hemisphere visibility, the AO gathers'
        # job: E = col pi (visible fraction)
        occ = _hemisphere_occlusion(scene, P, N, key, nsamples, active)
        if occ is not None:
            return (1.0 - occ / nsamples)[:, None] * col * math.pi

    if light.type in (LIGHT_DOME, LIGHT_SUNSKY, LIGHT_IBL):
        return _cosweight_gather(scene, light, P, N, key, nsamples, active)

    if light.type == LIGHT_AREA and light.tris is not None:
        total = torch.zeros_like(P)
        for si in range(nsamples):
            u = key.fold(si).uniform((P.shape[0], 3))
            wi, r, r2, cos_l, pdf_a = _area_geometry(light, P, u)
            cos_s = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
            vis = _shadow(scene, P, N, wi, r - 2.0 * scene.eps, active)
            g = cos_s * cos_l / r2
            total = total + (vis * g / torch.clamp_min(pdf_a, 1e-20)
                             )[:, None] * col
        return total / nsamples

    return torch.zeros_like(P)


def _env_contribution(scene, light, P, N, key, nsamples: int,
                      active=None) -> torch.Tensor:
    """Incident light of a textured dome or IBL light through its
    sampler (ibl.c:53-540; light->iblsampler, light.h:19-23), (B, 3);
    stratified takes n x n strata, n = max(1, int(sqrt(nsamples)))."""
    env = light.env
    col = light_color(light, P)
    sampler = light.ibl_sampler or "cosweight"
    if sampler == "importance":
        e = ibl.sample_env_importance(env.importance_table, scene, P, N, key,
                                      nsamples=nsamples, active=active)
    elif sampler == "stratified":
        n = max(1, int(math.sqrt(nsamples)))
        e = ibl.sample_env_stratified(env.fetch, scene, P, N, key, ntheta=n,
                                      nphi=n, active=active)
    elif sampler == "structured":
        dirs, rgb = env.structured
        if len(dirs) == 0:
            return torch.zeros_like(P)
        e = ibl.sample_env_structured(dirs, rgb, scene, P, N, active=active)
    elif sampler == "bruteforce":
        e = ibl.sample_env_bruteforce(env.importance_table, scene, P, N,
                                      active=active)
    else:  # cosweight (ibl.c:53), the default
        e = ibl.sample_env_cosweight(env.fetch, scene, P, N, key,
                                     nsamples=nsamples, active=active)
    return e * col[None, :]


def light_wi_cl(scene, light, P, N, key, index: int = 0):
    """One (direction (B, 3), shadowed colour (B, 3)) sample of a light,
    the binding behind RSL `illuminance` blocks (L and Cl); its random
    numbers at key.fold(7000 + index).  (None, None) for a light type
    with no single-direction sample."""
    B = P.shape[0]
    col = light_color(light, P)
    k = key.fold(7000 + index)
    if light.type in (LIGHT_DISTANT, LIGHT_SUN):
        wi = delta_direction(light, P)
        return wi, _shadow(scene, P, N, wi)[:, None] * col
    if light.type == LIGHT_POINT:
        d = _vec(light.position, P) - P
        r2 = torch.clamp_min(dot(d, d)[:, 0], 1e-12)
        r = torch.sqrt(r2)
        wi = d / r[:, None]
        vis = _shadow(scene, P, N, wi, r - 2.0 * scene.eps)
        return wi, (vis / r2)[:, None] * col
    if light.type == LIGHT_AREA and light.tris is not None:
        wi, r, r2, cos_l, pdf_a = _area_geometry(light, P, k.uniform((B, 3)))
        vis = _shadow(scene, P, N, wi, r - 2.0 * scene.eps)
        w = vis * cos_l / (r2 * torch.clamp_min(pdf_a, 1e-20))
        return wi, w[:, None] * col
    if light.type in (LIGHT_DOME, LIGHT_SUNSKY, LIGHT_IBL):
        ur = k.uniform((B, 2))
        wi, _pdf = cosweight_sample(ur[:, 0], ur[:, 1], ortho_basis(N))
        vis = _shadow(scene, P, N, wi)
        if light.type == LIGHT_SUNSKY and light.sunsky is not None:
            li = light.sunsky.sky_rgb_world(wi)
        elif light.env is not None:
            li = light.env.fetch(wi) * col[None, :]  # texture.c:238
        else:
            li = col.expand(P.shape)
        # Cl scaled so that Cl (L.N) integrates like the cosine gather
        cos = torch.clamp_min(dot(N, wi)[:, 0], 1e-6)
        return wi, vis[:, None] * li * (math.pi / cos)[:, None] / math.pi
    return None, None


def shadow_rays_per_hit(lights, nsamples: int = 4) -> int:
    """Shadow rays direct_diffuse and direct_specular trace per shaded
    hit, for the raytrace.c:96 ray count."""
    n = 0
    for light in lights or ():
        n += nsamples if light.type in GATHER_LIGHTS else 1
        if light.type in (LIGHT_DISTANT, LIGHT_SUN, LIGHT_POINT):
            n += 1  # direct_specular's highlight shadow ray
    return n


def direct_diffuse(scene, lights, P, N, key, nsamples: int = 4,
                   active=None) -> torch.Tensor:
    """diffuse(N) (shader.c:504): shadowed cosine lighting summed over the
    lights, / pi, (B, 3)."""
    total = torch.zeros_like(P)
    for i, light in enumerate(lights):
        n = nsamples if light.type in GATHER_LIGHTS else 1
        total = total + light_contribution(scene, light, P, N,
                                           key.fold(i + 1000), n,
                                           active=active)
    return total / math.pi


def direct_specular(scene, lights, P, N, V, roughness, key,
                    active=None) -> torch.Tensor:
    """specular(N, V, roughness) (shader.c:529): a shadowed Blinn-style
    highlight per distant, sun or point light, (B, 3).  roughness: a
    tensor on P's device, or a Python number, whose exponent is formed
    in f32 on the host: nothing is copied to the device."""
    total = torch.zeros_like(P)
    if torch.is_tensor(roughness):
        inv_r = 1.0 / torch.clamp_min(roughness.to(torch.float32), 1e-3)
    else:
        r = torch.tensor(roughness, dtype=torch.float32)
        inv_r = float(1.0 / torch.clamp_min(r, 1e-3))
    for light in lights:
        if light.type in (LIGHT_DISTANT, LIGHT_SUN):
            wi = delta_direction(light, P)
        elif light.type == LIGHT_POINT:
            d = _vec(light.position, P) - P
            wi = d / torch.clamp_min(norm(d), 1e-10)
        else:
            continue  # dome and area highlights are path tracing's
        h = wi + V
        h = h / torch.clamp_min(norm(h), 1e-20)
        ndoth = torch.clamp_min(dot(N, h)[:, 0], 0.0)
        cos = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
        vis = _shadow(scene, P, N, wi, active=active)
        total = total + (vis * (cos > 0) * torch.pow(ndoth, inv_r)
                         )[:, None] * light_color(light, P)
    return total
