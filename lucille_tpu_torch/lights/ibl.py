"""Image-based lighting samplers, in torch.

Counterpart of lucille_tpu/lights/ibl.py (src/render/ibl.c, selected per
light by the RIB token "sampling", lightsource.c:127-142):

- ``cosweight``  (ibl.c:53)  cosine-weighted hemisphere + env lookup;
- ``importance``             luminance-CDF texel sampling over the
  host-built table (`EnvImportanceTable`, on the render device);
- ``stratified``             stratified hemisphere + env lookup;
- ``structured``             precomputed SIS directions (lights/sisgen.py,
  or a bound sisfile), no random numbers;
- ``bruteforce`` (ibl.c:395) every env texel (at most 4096), a shadow
  wavefront each: the ground-truth oracle.

Every sampler returns (B, 3) incident radiance estimates for shading
points P with normals N, shadowed by `accel/dispatch.any_hit` wavefronts
(kernel 2 on the dense tiles, kernel 5 on the tile BVH); `active` (the
live lanes, or None) goes to any_hit, so a dead lane traces nothing on
the dense tiles and no live lane's answer changes.  Random numbers come
from a `sampling/jitter.StreamKey` folded where lucille_tpu folds its
key: cosweight and importance draw key.fold(si), stratified
key.fold(i * nphi + j).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lucille_tpu_torch.accel.dispatch import any_hit
from lucille_tpu_torch.ops.frame import cosweight_sample, dot, ortho_basis


def latlong_directions(h: int, w: int):
    """Direction + solid angle per texel of an (h, w) lat-long map (y-up)."""
    theta = (np.arange(h) + 0.5) / h * np.pi  # 0..pi from +y
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi - np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], axis=-1
    )
    solid = (np.pi / h) * (2.0 * np.pi / w) * np.sin(t)
    return dirs, solid


class EnvImportanceTable:
    """Luminance CDF over a lat-long environment map, built on the host in
    f64 as lucille_tpu builds it and copied to `device` once as f32 (cdf,
    dirs, radiance, solid, pdf: the casts lucille_tpu's jnp.asarray
    makes, so a draw picks the same texel)."""

    def __init__(self, image: np.ndarray, device):
        self.image = np.asarray(image, dtype=np.float32)
        h, w = self.image.shape[:2]
        self.h, self.w = h, w
        dirs, solid = latlong_directions(h, w)
        lum = self.image.mean(axis=-1) * solid
        flat = np.maximum(lum.reshape(-1), 0.0)
        total = flat.sum()
        self.total = float(total)
        dev = torch.device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.float32)).to(dev)

        self.cdf = put(np.cumsum(flat) / max(total, 1e-20))
        self.dirs = put(dirs.reshape(-1, 3))
        self.radiance = put(self.image.reshape(-1, 3))
        self.solid = put(solid.reshape(-1))
        self.pdf = put(flat / max(total, 1e-20)
                       / np.maximum(solid.reshape(-1), 1e-12))


def _visibility(scene, P, N, wi, active) -> torch.Tensor:
    """(B,) f32 1 where the shadow ray from P + N eps along wi escapes."""
    occ = any_hit(scene, P + N * scene.eps, wi, None, active)["occ"]
    return 1.0 - occ.to(torch.float32)


def _cos(N, wi) -> torch.Tensor:
    return torch.clamp_min(dot(N, wi)[:, 0], 0.0)


def sample_env_importance(table: EnvImportanceTable, scene, P, N, key,
                          nsamples=8, active=None):
    """Importance-sample the environment by luminance (ibl.c importance):
    sample si draws key.fold(si).uniform((B,)) and takes the texel whose
    CDF interval holds it (left side, as jnp.searchsorted)."""
    B = P.shape[0]
    total = torch.zeros_like(P)
    last = table.dirs.shape[0] - 1
    for si in range(nsamples):
        u = key.fold(si).uniform((B,)).contiguous()
        idx = torch.clamp(torch.searchsorted(table.cdf, u), 0, last)
        wi = table.dirs[idx]
        li = table.radiance[idx]
        pdf = torch.clamp_min(table.pdf[idx], 1e-9)
        vis = _visibility(scene, P, N, wi, active)
        total = total + li * ((_cos(N, wi) * vis) / pdf)[:, None]
    return total / nsamples


def sample_env_cosweight(env_fn, scene, P, N, key, nsamples=8,
                         active=None):
    """Cosine-weighted gather (ri_ibl_sample_cosweight, ibl.c:53);
    env_fn(dirs (B, 3)) -> (B, 3) radiance."""
    B = P.shape[0]
    basis = ortho_basis(N)
    total = torch.zeros_like(P)
    for si in range(nsamples):
        ur = key.fold(si).uniform((B, 2))
        wi, _ = cosweight_sample(ur[:, 0], ur[:, 1], basis)
        vis = _visibility(scene, P, N, wi, active)
        total = total + env_fn(wi) * (vis * math.pi)[:, None]
    return total / nsamples


def sample_env_stratified(env_fn, scene, P, N, key, ntheta=4, nphi=4,
                          active=None):
    """Stratified hemisphere gather (IBL_SAMPLING_STRATIFIED): stratum
    (i, j) draws key.fold(i * nphi + j).uniform((B, 2))."""
    B = P.shape[0]
    b0, b1, b2 = ortho_basis(N)
    total = torch.zeros_like(P)
    for i in range(ntheta):
        for j in range(nphi):
            ur = key.fold(i * nphi + j).uniform((B, 2))
            z0 = (i + ur[:, 0]) / ntheta
            z1 = (j + ur[:, 1]) / nphi
            cos_t = torch.sqrt(z0)
            phi = 2 * math.pi * z1
            s = torch.sqrt(1 - z0)
            wi = ((torch.cos(phi) * s)[:, None] * b0
                  + (torch.sin(phi) * s)[:, None] * b1
                  + cos_t[:, None] * b2)
            vis = _visibility(scene, P, N, wi, active)
            total = total + env_fn(wi) * (vis * math.pi)[:, None]
    return total / (ntheta * nphi)


def sample_env_structured(dirs, rgb, scene, P, N, active=None):
    """Structured importance sampling: (S, 3) directions with (S, 3)
    pre-integrated radiance weights (sisgen, or a bound sisfile), both
    already on P's device.  Deterministic: no random numbers."""
    total = torch.zeros_like(P)
    for si in range(dirs.shape[0]):
        wi = dirs[si].expand(P.shape)
        vis = _visibility(scene, P, N, wi, active)
        total = total + rgb[si] * (_cos(N, wi) * vis)[:, None]
    return total


def sample_env_bruteforce(table: EnvImportanceTable, scene, P, N,
                          max_texels=4096, active=None):
    """Integrate every environment texel (ri_ibl_sample_bruteforce,
    ibl.c:395): a Riemann sum Li cos vis (texel solid angle x stride)
    over every stride-th texel, at most `max_texels` shadow wavefronts."""
    ntex = table.dirs.shape[0]
    stride = max(1, int(np.ceil(ntex / max_texels)))
    total = torch.zeros_like(P)
    for i in range(0, ntex, stride):
        wi = table.dirs[i].expand(P.shape)
        vis = _visibility(scene, P, N, wi, active)
        dw = table.solid[i] * stride
        total = total + table.radiance[i] * (_cos(N, wi) * vis * dw)[:, None]
    return total
