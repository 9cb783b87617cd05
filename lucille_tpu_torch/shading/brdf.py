"""BRDF library: lambert, blinn, phong, modified phong, Ward anisotropic,
Ashikhmin-Shirley, and the modified phong's importance sampling.

Counterpart of lucille_tpu/shading/brdf.py (src/render/brdf.c:22-467) in
torch, elementwise and differentiable, with each model's conventions and
quirks kept (blinn's half-vector z component, brdf.c:39-55; Ward's half
vector built from the reflected view ray).  `wo` is the outgoing (view)
direction and `wi` the incident (light) direction, both pointing away
from the surface point; `n` the shading normal; all (..., 3) f32.  No
integrator or shader calls these, as in lucille_tpu.
"""

from __future__ import annotations

import math

import torch

from lucille_tpu_torch.shading.reflection import (
    cosn_sample,
    fresnel_schlick,
    reflect,
)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-20)


def lambert(wo, wi, n, kd):
    """kd * max(wi.n, 0)  (brdf.c:22-37; not divided by pi)."""
    del wo
    ldotn = _dot(wi, n)
    return torch.where(ldotn > 0.0, kd * ldotn, 0.0)


def blinn(wo, wi, n, kd, ks, glossness):
    """kd + ks * half.z^gloss  (brdf.c:39-55; the half vector in the local
    frame where z is up: callers pass tangent-frame vectors)."""
    del n
    h = _norm(wo + wi)
    return kd + ks * torch.pow(torch.clamp_min(h[..., 2], 0.0), glossness)


def phong(wo, wi, n, kd, ks, glossness):
    """kd / pi + ks * (r.wi)^gloss / (n.wi)  (brdf.c:58-82), r the mirror
    of the incident view ray reflect(-wo, n)."""
    r = reflect(-wo, n)
    rdotl = _dot(r, wi)
    ndotl = _dot(n, wi)
    ok = (rdotl > 0.0) & (ndotl > 0.0)
    spec = ks * torch.pow(torch.clamp_min(rdotl, 1e-20), glossness) \
        / torch.clamp_min(ndotl, 1e-20)
    return torch.where(ok, kd / math.pi + spec, 0.0)


def modified_phong(wo, wi, n, kd, ks, glossness):
    """Lafortune-Willems modified Phong (brdf.c:91-123):
    kd / pi + ks (gloss + 2) / (2 pi) (r.wi)^gloss."""
    rdotl = torch.clamp(_dot(reflect(-wo, n), wi), 0.0, 1.0)
    diffuse = kd / math.pi
    specular = ks * (glossness + 2.0) / (2.0 * math.pi) * torch.pow(
        torch.clamp_min(rdotl, 1e-20), glossness)
    return torch.where(rdotl > 0.0, diffuse + specular, 0.0)


def ward_anisotropic(wo, wi, n, u, v, kd, ks, ax, ay):
    """Ward's anisotropic BRDF (brdf.c:129-232): the half vector
    reflect(-wo, n) + wi (the reference's), the diffuse term alone where
    either cosine is not positive."""
    diffuse = kd / math.pi
    r = reflect(-wo, n)
    costr = _dot(r, n)
    costi = _dot(wi, n)
    h = _norm(r + wi)
    hdotn = _dot(h, n)
    hdotx = _dot(h, u)
    hdoty = _dot(h, v)
    c1 = 1.0 / torch.sqrt(torch.clamp_min(costi * costr, 1e-12))
    c2 = 1.0 / (4.0 * math.pi * ax * ay)
    c3 = ((hdotx / ax) ** 2 + (hdoty / ay) ** 2) / torch.clamp_min(
        1.0 + hdotn, 1e-8)
    specular = ks * c1 * c2 * torch.exp(-2.0 * c3)
    ok = (costr > 0.0) & (costi > 0.0)
    return torch.where(ok, diffuse + specular, diffuse)


def ashikhmin_shirley(wo, wi, n, u, v, kd_rgb, ks_rgb, nu, nv):
    """Ashikhmin-Shirley anisotropic BRDF (brdf.c:234-312): (..., 3) RGB,
    the coupled diffuse term and the anisotropic lobe with Schlick's
    Fresnel."""
    h = _norm(wo + wi)
    ndotwi = torch.clamp_min(_dot(n, wi), 0.0)
    ndotwo = torch.clamp_min(_dot(n, wo), 0.0)
    ndoth = torch.clamp_min(_dot(n, h), 0.0)
    hdotwi = torch.clamp_min(_dot(h, wi), 1e-8)
    hdotu = _dot(h, u)
    hdotv = _dot(h, v)

    denom_aniso = torch.clamp_min(1.0 - ndoth * ndoth, 1e-8)
    expo = (nu * hdotu**2 + nv * hdotv**2) / denom_aniso
    num = math.sqrt((nu + 1.0) * (nv + 1.0)) / (8.0 * math.pi)
    lobe = num * torch.pow(ndoth, expo) / (
        hdotwi * torch.maximum(ndotwi, ndotwo))
    f = fresnel_schlick(hdotwi[..., None], ks_rgb)
    specular = lobe[..., None] * f

    c = 28.0 / (23.0 * math.pi)
    d1 = 1.0 - (1.0 - ndotwi / 2.0) ** 5
    d2 = 1.0 - (1.0 - ndotwo / 2.0) ** 5
    diffuse = c * kd_rgb * (1.0 - ks_rgb) * (d1 * d2)[..., None]

    ok = ((ndotwi > 0.0) & (ndotwo > 0.0))[..., None]
    return torch.where(ok, diffuse + specular, 0.0)


def sample_modified_phong(wi, n, u0, u1, glossness):
    """Importance-sample the modified phong's glossy lobe
    (ri_sample_modified_phong, brdf.c:431-462): a cos^N direction about
    the reflection of `wi` in `n`.  Returns (wo, pdf)."""
    return cosn_sample(u0, u1, _norm(reflect(wi, n)), glossness)
