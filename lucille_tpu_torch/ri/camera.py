"""Raster -> world-space eye rays, in torch.

The counterpart of lucille_tpu/ri/camera.py:100-171.  The f32 constants
come from the jax-free `Camera.ray_constants`; the row-vector transform
is written as explicit products so it rounds exactly as the JAX version
does (no matmul, whose reduction order would differ).
"""

from __future__ import annotations

import torch

from lucille_tpu.ri.camera import PERSPECTIVE


def generate_rays(camera, px: torch.Tensor, py: torch.Tensor):
    """px, py: f32 raster positions (pixel corner + subpixel offset), any
    shape.  Returns (org, dir), each (..., 3) f32; dir is normalized.

    Perspective and orthographic projections; thin-lens depth of field
    is not ported yet and raises."""
    if camera.dof_active:
        raise NotImplementedError(
            "thin-lens depth of field is not ported yet "
            "(ROADMAP Queue 1: camera and film)"
        )
    origin, rot, trans, zview, sign = camera.ray_constants()
    r = [[float(rot[i, j]) for j in range(3)] for i in range(3)]
    tr = [float(x) for x in trans]
    w = float(camera.horizontal_resolution)
    h = float(camera.vertical_resolution)
    vx = (2.0 * px - w) / w
    vy = (2.0 * py - h) / h

    def xform(x, y, z):
        return [
            x * r[0][k] + y * r[1][k] + z * r[2][k] + tr[k] for k in range(3)
        ]

    if camera.camera_projection == PERSPECTIVE:
        org = [torch.full_like(vx, float(origin[k])) for k in range(3)]
        z = torch.full_like(vx, float(zview))
    else:
        org = xform(vx, vy, torch.zeros_like(vx))
        z = torch.full_like(vx, float(sign))
    d = [a - b for a, b in zip(xform(vx, vy, z), org)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    n = torch.clamp_min(n, 1e-20)
    return torch.stack(org, dim=-1), torch.stack([c / n for c in d], dim=-1)
