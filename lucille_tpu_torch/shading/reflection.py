"""Reflection, refraction, Fresnel and hemisphere sampling, in torch.

Counterpart of lucille_tpu/shading/reflection.py (the reference's
src/render/reflection.c), with the same f32 formulas:

- `reflect` (reflection.c:26): r = in - 2 n (in . n);
- `refract` (reflection.c:70): Snell with total internal reflection
  falling back to the reflection; the incident side is inferred from
  sign(in . n); eta a scalar or one per lane;
- `fresnel` (reflection.c:221): exact dielectric coefficients;
- `fresnel_schlick`: Schlick's approximation (brdf.c's fresnel_approx);
- `cosn_sample`: a cos^N lobe about an axis (brdf.c:431-462).

Dot products and norms over the last axis (size 3) are summed left to
right (ops/frame.py, which also holds the frame and `cosweight_sample`),
so they round as the JAX package's do.
"""

from __future__ import annotations

import math

import torch

from lucille_tpu_torch.ops.frame import dot, norm, ortho_basis


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp_min(norm(v), eps)


def reflect(inc: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """r = inc - 2 n (inc . n)   (reflection.c:26-50)."""
    return inc - 2.0 * dot(inc, n) * n


def refract(inc: torch.Tensor, n: torch.Tensor, eta):
    """Refraction with the TIR fallback (reflection.c:70-127).  eta: the
    relative IOR (n2 / n1 entering), a tensor on inc's device ((B,) per
    lane) or a Python number (nothing is copied to the device; 1 / eta is
    formed in f32 on the host).  Returns (dir (..., 3), tir (...,) bool)."""
    cos1 = dot(inc, n)
    entering = cos1 < 0.0
    if torch.is_tensor(eta):
        eta = eta.to(torch.float32)
        if eta.dim() == inc.dim() - 1:  # per-lane eta (B,), (B, 3) rays
            eta = eta[..., None]
        e = torch.where(entering, 1.0 / eta, eta)
    else:
        eta32 = torch.tensor(eta, dtype=torch.float32)
        e = torch.where(entering, float(1.0 / eta32), float(eta32))
    N = torch.where(entering, n, -n)
    c1 = cos1.abs()
    k = 1.0 - e * e * (1.0 - c1 * c1)
    tir = k <= 0.0
    coeff = e * c1 - torch.sqrt(torch.clamp_min(k, 0.0))
    t = normalize(coeff * N + e * inc)
    r = normalize(reflect(inc, n))
    return torch.where(tir, r, t), tir[..., 0]


def fresnel(inc: torch.Tensor, n: torch.Tensor, eta):
    """Exact dielectric Fresnel (reflection.c:221-312).  Returns (r_dir,
    t_dir, kr, kt): the reflected and transmitted directions and the
    energy coefficients; kr = 1, kt = 0 under total internal reflection."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=inc.device)
    r = normalize(reflect(inc, n))
    t, tir = refract(inc, n, eta)
    d = dot(inc, n)[..., 0]
    c1 = d.abs()
    # g^2 = eta^2 + c^2 - 1 (with eta oriented to the incident side)
    e = torch.where(d < 0.0, eta, 1.0 / eta)
    g2 = e * e + c1 * c1 - 1.0
    g = torch.sqrt(torch.clamp_min(g2, 0.0))
    gpc = g + c1
    gmc = g - c1
    a = torch.where(gpc > 1e-12, gmc / gpc, 1.0)
    b_num = c1 * gpc - 1.0
    b_den = c1 * gmc + 1.0
    b = torch.where(b_den.abs() > 1e-12, b_num / b_den, 0.0)
    kr = 0.5 * a * a * (1.0 + b * b)
    kr = torch.where(tir, 1.0, torch.clamp(kr, 0.0, 1.0))
    return r, t, kr, 1.0 - kr


def fresnel_schlick(cos_theta, f0: float = 0.1):
    """Schlick's approximation (brdf.c fresnel_approx: s = 0.1)."""
    p = 1.0 - cos_theta
    p5 = (p * p) * (p * p) * p
    return f0 + (1.0 - f0) * p5


def cosn_sample(u0: torch.Tensor, u1: torch.Tensor, axis: torch.Tensor,
                glossness):
    """cos^N-weighted direction about `axis` (ri_random_vector_cosNweight,
    brdf.c:431-462).  Returns (dir (..., 3), pdf (...,))."""
    b0, b1, a = ortho_basis(axis)
    cos_t = torch.clamp_min(u0, 1e-12) ** (1.0 / (glossness + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = (2.0 * math.pi) * u1
    d = ((torch.cos(phi) * sin_t)[..., None] * b0
         + (torch.sin(phi) * sin_t)[..., None] * b1
         + cos_t[..., None] * a)
    pdf = (glossness + 1.0) / (2.0 * math.pi) * cos_t ** glossness
    return d, pdf
