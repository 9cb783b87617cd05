"""RenderMan camera: setup on the host, raster -> world-space eye rays in
torch.

`Camera` and its projection constants are the port's copy of
lucille_tpu/ri/camera.py:29-98 and :173-193 (setup, `ray_constants`,
`dof_active`, the NumPy `generate_rays_host`), the same code; the JAX
method `Camera.generate_rays` is not copied.  Its torch counterpart is
the module function `generate_rays` below (lucille_tpu/ri/camera.py:
100-171), thin-lens depth of field included: the f32 constants come
from `Camera.ray_constants`, and the row-vector transform is written as
explicit products so it rounds as the JAX version does (no matmul,
whose reduction order would differ).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from lucille_tpu_torch.ops import vecmat as vm

PERSPECTIVE = "perspective"
ORTHOGRAPHIC = "orthographic"


@dataclass
class Camera:
    """Camera state (reference ri_camera_t, camera.h:30-89)."""

    horizontal_resolution: int = 640
    vertical_resolution: int = 480
    pixel_aspect_ratio: float = 1.0
    crop_window: tuple = (0.0, 1.0, 0.0, 1.0)
    screen_window: tuple = (-4.0 / 3.0, 4.0 / 3.0, -1.0, 1.0)
    camera_projection: str = ORTHOGRAPHIC  # RI default; Projection overrides
    fov: float = 90.0
    # depth of field (camera.h: fstop/focal_length/focal_distance)
    fstop: float = math.inf
    focal_length: float = 0.0
    focal_distance: float = 0.0
    # shutter
    shutter_open: float = 0.0
    shutter_close: float = 0.0
    # derived at setup
    flength: float = 0.0
    is_rh: bool = False
    camera_to_world: np.ndarray = field(default_factory=vm.mat4_identity)

    def setup(self, world_to_camera: np.ndarray, orientation: str) -> None:
        """Compute camera_to_world (reference ri_camera_setup, camera.c:214)."""
        self.flength = 1.0 / math.tan((self.fov * math.pi / 180.0) * 0.5)
        ori = vm.mat4_identity()
        self.is_rh = orientation == "rh"
        if self.is_rh:
            ori[2, 2] = -ori[2, 2]
        m = vm.mat4_inverse(world_to_camera)
        self.camera_to_world = vm.mat4_mul(m, ori)

    # -- device-side ray generation --------------------------------------

    def ray_constants(self):
        """Precompute the float32 constants generate_rays needs.

        Returns (origin (3,), mat3 (3,3), zview scalar, sign) where a view
        vector v = (vx, vy, zview) maps to world dir = v @ mat3 (+ the
        camera position handling done in generate_rays).
        """
        c2w = self.camera_to_world
        sign = -1.0 if self.is_rh else 1.0
        origin = vm.transform_point(np.zeros(3), c2w)
        return (
            origin.astype(np.float32),
            c2w[:3, :3].astype(np.float32),
            c2w[3, :3].astype(np.float32),
            np.float32(sign * self.flength),
            np.float32(sign),
        )

    @property
    def dof_active(self) -> bool:
        """Thin-lens sampling fires only when RiDepthOfField gave a finite
        fstop and positive focal settings (camera.h:30-89 params; the
        reference's own dof() hook is parked under `#if 0` with a "TODO:
        fix this" at camera.c:284-312 — here it works)."""
        return (
            self.camera_projection == PERSPECTIVE
            and math.isfinite(self.fstop)
            and self.fstop > 0.0
            and self.focal_length > 0.0
            and self.focal_distance > 0.0
        )

    def generate_rays_host(self, px, py):
        """NumPy float64 twin of generate_rays for golden-path testing."""
        c2w = self.camera_to_world
        sign = -1.0 if self.is_rh else 1.0
        w = float(self.horizontal_resolution)
        h = float(self.vertical_resolution)
        px = np.asarray(px, dtype=np.float64)
        py = np.asarray(py, dtype=np.float64)
        vx = (2.0 * px - w) / w
        vy = (2.0 * py - h) / h
        vz = np.full_like(vx, sign * self.flength)
        v = np.stack([vx, vy, vz], axis=-1)
        if self.camera_projection == PERSPECTIVE:
            org = np.broadcast_to(vm.transform_point(np.zeros(3), c2w), v.shape)
            d = vm.transform_point(v, c2w) - org
        else:
            p = np.stack([vx, vy, np.zeros_like(vx)], axis=-1)
            org = vm.transform_point(p, c2w)
            p2 = np.stack([vx, vy, np.full_like(vx, sign)], axis=-1)
            d = vm.transform_point(p2, c2w) - org
        return org, vm.normalize(d)


def generate_rays(camera, px: torch.Tensor, py: torch.Tensor,
                  lens_u: torch.Tensor | None = None):
    """px, py: f32 raster positions (pixel corner + subpixel offset), any
    shape.  Returns (org, dir), each (..., 3) f32; dir is normalized.

    Perspective and orthographic projections, and thin-lens depth of
    field (lucille_tpu/ri/camera.py:124-150) when the camera's
    `dof_active`: lens_u, (..., 2) uniforms, places each ray's origin on
    the lens disk (radius focal_length / (2 fstop), an area-uniform polar
    sample) and aims it through the ray's in-focus point at camera depth
    focal_distance.  A depth-of-field camera without lens samples raises:
    the renderer always draws them."""
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

    if camera.dof_active:
        if lens_u is None:
            raise ValueError("a depth-of-field camera needs lens samples "
                             "(lens_u)")
        # the f32 constants of the JAX version
        aperture = float(np.float32(camera.focal_length / (2.0 * camera.fstop)))
        tf = float(np.float32(camera.focal_distance / camera.flength))
        fz = float(np.float32(float(sign) * camera.focal_distance))
        rad = aperture * torch.sqrt(lens_u[..., 0])
        th = (2.0 * math.pi) * lens_u[..., 1]
        lx = rad * torch.cos(th)
        ly = rad * torch.sin(th)
        org = xform(lx, ly, torch.zeros_like(lx))
        d = [a - b for a, b in zip(
            xform(vx * tf, vy * tf, torch.full_like(vx, fz)), org)]
    else:
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
