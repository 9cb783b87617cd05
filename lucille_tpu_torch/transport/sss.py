"""Subsurface single scattering.

Counterpart of lucille_tpu/transport/sss.py: the single-scattering term
of Jensen et al., "A Practical Model for Subsurface Light Transport"
(SIGGRAPH 2001), which the reference's unfinished src/render/sss.c:40-155
sketches:

1. refract the eye ray into the medium (eta ~ 1.4, sss.c:133);
2. sample a scatter depth s' = -log(u) / sigma_t along it (sss.c:119-146);
3. from the scatter point gather each distant, sun or point light,
   attenuated by Beer-Lambert along both segments inside the medium,
   scaled by the phase function (isotropic, or a Lorenz-Mie table from
   ops/mie.py at the in-medium scattering angle) and the diffuse Fresnel
   transmittance (Fdr, sss.c:157-166), shadowed by an any-hit from the
   light's entry point.

One scatter sample a lane a stratum; the depth light travels inside the
medium is the reference's distant-light simplification (sss.c:96-98).
Random numbers: key.fold(si).uniform((B,)) for sample si, mapped to
[1e-6, 1) as lucille_tpu's uniform(fold_in(key, si), (B,), minval=1e-6)
maps its draw.  A distant or sun light is gathered along -direction
(lucille_tpu's sss does so for both, where its integrators trace a sun
along +direction).  No
integrator calls it, as in lucille_tpu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lucille_tpu_torch.accel.dispatch import any_hit
from lucille_tpu_torch.device import const_vec
from lucille_tpu_torch.lights.tables import LIGHT_DISTANT, LIGHT_POINT, LIGHT_SUN
from lucille_tpu_torch.lights.sampling import light_color
from lucille_tpu_torch.ops.frame import dot, norm
from lucille_tpu_torch.shading.reflection import refract

SSS_LIGHTS = (LIGHT_DISTANT, LIGHT_SUN, LIGHT_POINT)
# the scatter depth's uniforms on [1e-6, 1), formed in f32 as
# jax.random.uniform(minval=1e-6) forms them
U_MIN = float(np.float32(1e-6))
U_SCALE = float(np.float32(1.0) - np.float32(1e-6))


def fresnel_diffuse_reflectance(eta: float) -> float:
    """Fdr = -1.440 / eta^2 + 0.710 / eta + 0.668 + 0.0636 eta
    (sss.c:160-166)."""
    return -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta


def single_scattering(scene, lights, P, N, I, key, sigma_t: float = 2.19,
                      sigma_s: float = 2.19 - 0.0021, eta: float = 1.4,
                      nsamples: int = 4, phase_table=None) -> torch.Tensor:
    """Single-scattering radiance (B, 3) at surface points P with normals
    N and incident (eye) directions I (toward the surface), each (B, 3);
    key a sampling/jitter.StreamKey.  Defaults: the reference's options
    (option.c:104-107) and eta (sss.c:133); phase_table None is the
    isotropic 1 / (4 pi) phase."""
    B = P.shape[0]
    albedo_ss = sigma_s / sigma_t
    To, _tir = refract(I, N, eta)
    ft = 1.0 - fresnel_diffuse_reflectance(eta)
    n_lights = max(1, len(lights.lights))
    total = torch.zeros((B, 3), dtype=torch.float32, device=P.device)
    for si in range(nsamples):
        u = torch.clamp_min(key.fold(si).uniform((B,)) * U_SCALE + U_MIN,
                            U_MIN)
        s_dist = -torch.log(u) / sigma_t  # sss.c:146
        s_o = P + s_dist[:, None] * To  # the scatter point
        for light in lights:
            if light.type not in SSS_LIGHTS:
                continue
            col = light_color(light, P)[None, :]
            if light.type == LIGHT_POINT:
                d = const_vec(light.position, P.device) - s_o
                r = torch.clamp_min(norm(d)[:, 0], 1e-9)
                wi = d / r[:, None]
                col = col / torch.clamp_min(r * r, 1e-6)[:, None]
            else:  # -direction for the sun too, as lucille_tpu's sss does
                wi = -const_vec(light.direction, P.device)
                wi = (wi / torch.clamp_min(norm(wi[None])[0], 1e-20)
                      ).expand(P.shape)
            # the depth light travels inside the medium: the scatter depth
            # projected onto the light's direction
            cos_i = torch.clamp_min(dot(N, wi)[:, 0], 1e-3)
            si_dist = s_dist * torch.clamp_min(dot(-To, N)[:, 0], 1e-3) \
                / cos_i
            entry = s_o + wi * si_dist[:, None]
            vis = 1.0 - any_hit(scene, entry + N * scene.eps, wi)["occ"].to(
                torch.float32)
            atten = torch.exp(-sigma_t * (s_dist + si_dist))
            if phase_table is None:
                phase = 1.0 / (4.0 * math.pi)
            else:
                from lucille_tpu_torch.ops.mie import phase_lookup

                phase = phase_lookup(phase_table, dot(To, wi)[:, 0])
            contrib = (albedo_ss * phase * ft * atten * vis * cos_i
                       )[:, None] * col
            total = total + contrib / n_lights
    return total * (sigma_s / nsamples)
