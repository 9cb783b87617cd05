"""The shading frame's vector math, in torch: what every layer that builds
or samples a hemisphere uses.

- `norm` and `dot` over the last axis (size 3), keepdim, summed left to
  right so they round as the JAX package's do;
- `ortho_basis`, the branchless Frisvad/Duff frame of a unit normal
  (lucille_tpu/transport/ao.py's);
- `cosweight_sample`, a cosine-weighted hemisphere direction
  (reflection.c:131; lucille_tpu/shading/reflection.py's).
"""

from __future__ import annotations

import math

import torch


def norm(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis (size 3), keepdim, summed left to right."""
    return torch.sqrt(x[..., 0:1] * x[..., 0:1] + x[..., 1:2] * x[..., 1:2]
                      + x[..., 2:3] * x[..., 2:3])


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (size 3), keepdim, summed left to right."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


def ortho_basis(n: torch.Tensor):
    """Branchless Frisvad/Duff frame (b0, b1, n) for unit normals (B, 3),
    continuous in n except at n = (0, 0, -1)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = torch.clamp(-1.0 / (s + nz), -1e3, 1e3)
    b = nx * ny * a
    b0 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    b1 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    b0 = b0 / torch.clamp_min(norm(b0), 1e-20)
    b1 = b1 / torch.clamp_min(norm(b1), 1e-20)
    return b0, b1, n


def cosweight_sample(u0: torch.Tensor, u1: torch.Tensor, basis):
    """Cosine-weighted hemisphere direction (reflection.c:131-160).  u0,
    u1 (...,) uniforms; basis (b0, b1, n) each (..., 3).  Returns (dir
    (..., 3), pdf (...,))."""
    b0, b1, n = basis
    cos_t = torch.sqrt(torch.clamp_min(u0, 0.0))
    phi = (2.0 * math.pi) * u1
    sin_t = torch.sqrt(torch.clamp_min(1.0 - u0, 0.0))
    x = torch.cos(phi) * sin_t
    y = torch.sin(phi) * sin_t
    d = x[..., None] * b0 + y[..., None] * b1 + cos_t[..., None] * n
    return d, cos_t / math.pi
