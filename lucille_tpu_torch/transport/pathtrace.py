"""Multi-bounce path tracing with next-event estimation, in torch.

Counterpart of lucille_tpu/transport/pathtrace.py:196-415: one bounded
bounce loop, each lane carrying (org, dir, throughput, active).  Per
bounce: the closest hit; escaped live rays collect the environment;
emission seen directly at depth 0; next-event estimation with one light
picked uniformly among the distant, sun, point and area lights
(`_sample_one_light`, its shadow ray, the lambertian BRDF); the
cosine-weighted diffuse continuation; Russian roulette on the
throughput's luminance from MIN_BOUNCES.

The port follows lucille_tpu's code as it is, its estimator gaps
included (ROADMAP Queue 3): BRDF-sampled emitter hits past depth 0 are
dropped, the continuation is diffuse only, and the solid-angle pdf the
light sample returns is unused (lucille_tpu defines a power heuristic
and calls it nowhere; the port leaves it out).

As in transport/whitted.py, every bounce runs under the live mask where
lucille_tpu skips a bounce with no live lane; the state and the ray
count are the same.  Random numbers: fold(depth) per bounce; inside NEE
fold(0) for the light pick and fold(i + 1) per light; fold(99) for the
bounce direction, fold(7) for the roulette.
"""

from __future__ import annotations

import math

import torch

from lucille_tpu_torch.accel.dispatch import closest_hit
from lucille_tpu_torch.lights.sampling import (
    _area_geometry,
    _vec,
    delta_direction,
    light_color,
    occlusion,
)
from lucille_tpu_torch.lights.tables import (
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_POINT,
    LIGHT_SUN,
)
from lucille_tpu_torch.ops.frame import cosweight_sample, dot, ortho_basis
from lucille_tpu_torch.transport.common import (
    apply_texture,
    background_radiance,
    face_forward,
    interp_hit,
)

MIN_BOUNCES = 3
NEE_LIGHTS = (LIGHT_DISTANT, LIGHT_SUN, LIGHT_POINT, LIGHT_AREA)


def _sample_one_light(scene, lights, P, N, key, active=None):
    """NEE: one light picked uniformly among the delta and area lights,
    sampled and shadowed.  Returns (contrib (B, 3) = Li G vis / pdf,
    wi (B, 3), pdf_sa (B,) in solid angle, inf for delta lights).
    Environment lights are left to the escaped rays (lucille_tpu's
    furnace-test note, pathtrace.py:210-214)."""
    B = P.shape[0]
    nee = [(i, li) for i, li in enumerate(lights) if li.type in NEE_LIGHTS]
    nl = len(nee)
    if nl == 0:
        z = torch.zeros_like(P)
        return z, z, torch.zeros(B, device=P.device)
    pick = key.fold(0).randint((B,), nl)
    total = torch.zeros_like(P)
    wi_out = torch.zeros_like(P)
    pdf_out = torch.zeros(B, device=P.device)
    org = P + N * scene.eps
    for sel_i, (i, light) in enumerate(nee):
        sel = pick == sel_i
        col = light_color(light, P)
        if light.type in (LIGHT_DISTANT, LIGHT_SUN):
            wi = delta_direction(light, P)
            cos = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
            vis = 1.0 - occlusion(scene, org, wi, active=active)
            contrib = (cos * vis)[:, None] * col * nl  # / (1 / nl) pick pdf
            pdf_sa = torch.full((B,), math.inf, device=P.device)
        elif light.type == LIGHT_POINT:
            d = _vec(light.position, P) - P
            r2 = torch.clamp_min(dot(d, d)[:, 0], 1e-10)
            r = torch.sqrt(r2)
            wi = d / r[:, None]
            cos = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
            vis = 1.0 - occlusion(scene, org, wi, r - 2 * scene.eps, active)
            contrib = (cos * vis / r2)[:, None] * col * nl
            pdf_sa = torch.full((B,), math.inf, device=P.device)
        elif light.tris is not None:  # an area light
            u = key.fold(i + 1).uniform((B, 3))
            wi, r, r2, cos_l, pdf_a = _area_geometry(light, P, u)
            cos_s = torch.clamp_min(dot(N, wi)[:, 0], 0.0)
            vis = 1.0 - occlusion(scene, org, wi, r - 2 * scene.eps, active)
            g = cos_s * cos_l / r2
            pdf_sa = pdf_a * r2 / torch.clamp_min(cos_l, 1e-8)
            contrib = (vis * g / torch.clamp_min(pdf_a, 1e-20))[:, None] \
                * col * nl
        else:
            continue
        total = torch.where(sel[:, None], contrib, total)
        wi_out = torch.where(sel[:, None], wi, wi_out)
        pdf_out = torch.where(sel, pdf_sa, pdf_out)
    return total, wi_out, pdf_out


def path_radiance(scene, lights, org, dirn, key, max_depth: int = 10,
                  bgcolor=(0.0, 0.0, 0.0), textures=None):
    """Path-traced radiance of a wavefront org, dirn (B, 3) f32; key a
    sampling/jitter.StreamKey, textures the renderer's atlas (or None).
    Returns (radiance (B, 3), aux {nrays,
    hit, t} with the eye bounce's hit mask and t)."""
    B = org.shape[0]
    dev = org.device
    has_nee = any(li.type in NEE_LIGHTS for li in (lights or ()))
    radiance = torch.zeros((B, 3), device=dev)
    throughput = torch.ones((B, 3), device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    eye = None
    for depth in range(max_depth):
        res = closest_hit(scene, org, dirn,
                          active=None if depth == 0 else active)
        if depth == 0:
            eye = res
            nrays = nrays + B
        else:
            nrays = nrays + active.sum()
        hit = res["hit"] & active
        h = interp_hit(scene, res, org, dirn)
        N = face_forward(h["Ns"], dirn)
        P = h["P"]

        env = background_radiance(lights, dirn, bgcolor)
        radiance = radiance + torch.where((active & ~res["hit"])[:, None],
                                          throughput * env, 0.0)
        # emission seen directly; deeper emitter hits are NEE's (dropped,
        # as lucille_tpu drops them)
        if depth == 0:
            radiance = radiance + torch.where(
                hit[:, None], throughput * h["emission"], 0.0)

        kdepth = key.fold(depth)
        albedo = apply_texture(scene, textures, h,
                               h["cs"] * h["mat_color"] * h["kd"][:, None])
        nee, _wi, _pdf = _sample_one_light(scene, lights, P, N, kdepth,
                                           active=hit)
        radiance = radiance + torch.where(
            hit[:, None], throughput * (albedo / math.pi) * nee, 0.0)
        if has_nee:  # the NEE shadow ray
            nrays = nrays + hit.sum()
        if depth == max_depth - 1:
            break

        # the cosine-weighted diffuse bounce: f cos / pdf = albedo
        ur = kdepth.fold(99).uniform((B, 2))
        new_dir, _pdf = cosweight_sample(ur[:, 0], ur[:, 1], ortho_basis(N))
        throughput = torch.where(hit[:, None], throughput * albedo,
                                 throughput)
        if depth >= MIN_BOUNCES:  # Russian roulette on the luminance
            lum = torch.clamp(0.2126 * throughput[:, 0]
                              + 0.7152 * throughput[:, 1]
                              + 0.0722 * throughput[:, 2], 0.05, 1.0)
            survive = kdepth.fold(7).uniform((B,)) < lum
            throughput = torch.where(survive[:, None],
                                     throughput / lum[:, None], throughput)
            hit = hit & survive
        org = torch.where(hit[:, None], P + N * scene.eps, org)
        dirn = torch.where(hit[:, None], new_dir, dirn).contiguous()
        active = hit
    return radiance, {"nrays": nrays, "hit": eye["hit"], "t": eye["t"]}
