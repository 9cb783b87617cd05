"""Perlin-style gradient noise for procedural shaders, in torch.

Counterpart of lucille_tpu/ops/noise.py (src/render/noise.c, the RSL
``noise()`` builtin): Perlin's improved noise (2002) with the same
permutation table hashed in int32, the same quintic fade and gradient
dot products, and output in [0, 1], on the input's device.  The table
is copied to a device once (`_perm`); nothing else is.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# deterministic permutation table (Perlin's reference table)
_P = np.array(
    [151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
     140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
     247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
     57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
     74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
     60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
     65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
     200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
     52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
     207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
     119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
     129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
     218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
     81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
     184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
     222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180],
    dtype=np.int32,
)
_PERM = np.concatenate([_P, _P])



@lru_cache(maxsize=None)
def _perm(device: torch.device) -> torch.Tensor:
    """_PERM as an int32 tensor on `device`, copied there once."""
    return torch.from_numpy(_PERM).to(device)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    h = h & 15
    uu = torch.where(h < 8, x, y)
    vv = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where((h & 1) == 0, uu, -uu)
            + torch.where((h & 2) == 0, vv, -vv))


def _lerp(t, a, b):
    return a + t * (b - a)


def perlin3(p: torch.Tensor, perm: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Improved Perlin noise at points p (..., 3) f32, in [0, 1] (the RSL
    noise() convention).  perm: `_perm(p.device)`, if the caller holds it."""
    if perm is None:
        perm = _perm(p.device)

    def at(i):
        return perm[i.long()]

    fl = torch.floor(p)
    pi = fl.to(torch.int32) & 255
    pf = p - fl
    u, v, w = _fade(pf[..., 0]), _fade(pf[..., 1]), _fade(pf[..., 2])
    X, Y, Z = pi[..., 0], pi[..., 1], pi[..., 2]
    x, y, z = pf[..., 0], pf[..., 1], pf[..., 2]

    A = at(X) + Y
    AA = at(A) + Z
    AB = at(A + 1) + Z
    B = at(X + 1) + Y
    BA = at(B) + Z
    BB = at(B + 1) + Z

    n = _lerp(
        w,
        _lerp(
            v,
            _lerp(u, _grad(at(AA), x, y, z), _grad(at(BA), x - 1, y, z)),
            _lerp(u, _grad(at(AB), x, y - 1, z),
                  _grad(at(BB), x - 1, y - 1, z)),
        ),
        _lerp(
            v,
            _lerp(u, _grad(at(AA + 1), x, y, z - 1),
                  _grad(at(BA + 1), x - 1, y, z - 1)),
            _lerp(u, _grad(at(AB + 1), x, y - 1, z - 1),
                  _grad(at(BB + 1), x - 1, y - 1, z - 1)),
        ),
    )
    return 0.5 * (n + 1.0)


def turbulence3(p: torch.Tensor, octaves: int = 4) -> torch.Tensor:
    """Sum of |noise| octaves (procedural shader helper)."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    amp = 1.0
    freq = 1.0
    for _ in range(octaves):
        total = total + amp * torch.abs(perlin3(p * freq) * 2.0 - 1.0)
        amp *= 0.5
        freq *= 2.0
    return total
