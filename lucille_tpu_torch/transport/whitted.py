"""Whitted ray tracing as a bounded wavefront loop, in torch.

Counterpart of lucille_tpu/transport/whitted.py:44-155 (the reference's
whitted.c:24-70, depth <= 8): every lane carries a throughput and one
continuation ray.  Per bounce: the closest hit (the live lanes only);
escaped live rays pick up the environment (`background_radiance`); hit
emission; direct diffuse and specular light (lights/sampling.py, whose
constant dome is the AO gather); then the continuation, one branch per
lane chosen between reflection and refraction by the Fresnel
coefficients (lucille_tpu's stochastic selection).

lucille_tpu skips a bounce whose lanes are all dead (`lax.cond` on
any(active)).  The port runs every bounce under the mask instead: a dead
lane's closest hit does no work, its gathers and shadow rays trace
nothing, and every update is masked, so the state and the ray count are
the ones a skipped bounce leaves, and nothing waits on the device (the
renderer enqueues every tile before it pulls one).

Ray accounting as lucille_tpu's (raytrace.c:96): B eye rays, then the
live lanes' bounce rays, plus `shadow_rays_per_hit` per shaded hit.
Random numbers: fold(depth) per bounce, fold(i + 1000) per light inside
direct_diffuse, fold(7) of the bounce's key for the Fresnel choice.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.accel.dispatch import closest_hit
from lucille_tpu_torch.lights.sampling import (
    direct_diffuse,
    direct_specular,
    shadow_rays_per_hit,
)
from lucille_tpu_torch.shading.reflection import fresnel, normalize, reflect
from lucille_tpu_torch.transport.common import (
    apply_texture,
    background_radiance,
    face_forward,
    interp_hit,
)


def whitted_radiance(scene, lights, org, dirn, key, max_depth: int = 8,
                     bgcolor=(0.0, 0.0, 0.0), textures=None):
    """Wavefront Whitted integrator: org, dirn (B, 3) f32, key a
    sampling/jitter.StreamKey, textures the renderer's atlas (or None).
    Returns (radiance (B, 3), aux {nrays,
    hit, t} with the eye bounce's hit mask and t)."""
    B = org.shape[0]
    dev = org.device
    nshadow = shadow_rays_per_hit(lights)
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
        radiance = radiance + torch.where(hit[:, None],
                                          throughput * h["emission"], 0.0)

        kdir = key.fold(depth)
        diff = direct_diffuse(scene, lights, P, N, kdir, active=hit)
        spec = direct_specular(scene, lights, P, N, -dirn, h["roughness"],
                               kdir, active=hit)
        base = apply_texture(scene, textures, h, h["cs"] * h["mat_color"])
        local = base * h["kd"][:, None] * diff + h["ks"][:, None] * spec
        radiance = radiance + torch.where(hit[:, None], throughput * local,
                                          0.0)
        nrays = nrays + hit.sum() * nshadow
        if depth == max_depth - 1:
            break

        # continuation: reflect or refract, picked by the Fresnel weights
        refl = normalize(reflect(dirn, N))
        _r, t_dir, _kr, kt = fresnel(dirn, N, torch.clamp_min(h["ior"], 1.001))
        u = kdir.fold(7).uniform((B,))
        kt_mat = h["kt"]
        choose_refract = (u < kt) & (kt_mat > 1e-4)
        new_dir = torch.where(choose_refract[:, None], t_dir, refl)
        gain = torch.where(choose_refract, kt_mat, h["ks"])[:, None]
        cont = hit & ((h["ks"] > 1e-4) | (kt_mat > 1e-4))
        throughput = torch.where(cont[:, None], throughput * gain, throughput)
        # refracted rays push through the surface, reflected ones off it
        off = torch.where(choose_refract[:, None], -N, N) * scene.eps
        org = torch.where(cont[:, None], P + off, org)
        dirn = torch.where(cont[:, None], new_dir, dirn).contiguous()
        active = cont
    return radiance, {"nrays": nrays, "hit": eye["hit"], "t": eye["t"]}
