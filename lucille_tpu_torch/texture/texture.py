"""Textures on the device: bilinear fetch, IBL projections, mipmaps, SAT.

Counterpart of lucille_tpu/texture/texture.py:

- `build_mipmaps` and `summed_area_table` are the same NumPy code
  (texture_loader.c:368-403, texture.h:45-60);
- `TextureAtlas` stacks every scene texture, padded to a common (H, W),
  into one (T, H, W, 3) f32 tensor beside (T, 2) i32 true sizes, on an
  explicit device, so any wavefront fetches from any texture with one
  gather;
- `TextureAtlas.fetch` is the bilinear fetch with clamp addressing of
  ri_texture_fetch (texture.c:86), written in torch with lucille_tpu's
  operation order: index arithmetic and gathers on the device, no host
  copy and no host read, so a tile that fetches never waits on the card;
- `ibl_fetch_latlong` and `ibl_fetch_angular` are the environment
  projections (texture.c:238, texture.h:100-105).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


def build_mipmaps(img: np.ndarray, max_levels: int = 12):
    """Box-filtered mip chain (texture_loader.c:368-403 capability)."""
    levels = [np.asarray(img, dtype=np.float32)]
    cur = levels[0]
    while min(cur.shape[0], cur.shape[1]) > 1 and len(levels) < max_levels:
        h2 = max(1, cur.shape[0] // 2)
        w2 = max(1, cur.shape[1] // 2)
        cur = cur[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        levels.append(cur.astype(np.float32))
    return levels


def summed_area_table(img: np.ndarray) -> np.ndarray:
    """SAT over luminance (texture.h:45-60): sat[y, x] = sum img[:y, :x]."""
    lum = np.asarray(img, dtype=np.float64)
    if lum.ndim == 3:
        lum = lum.mean(axis=-1)
    return lum.cumsum(axis=0).cumsum(axis=1)


@dataclass
class TextureAtlas:
    """All scene textures in one stacked tensor (module docstring); an
    atlas without textures has data None and fetches white."""

    data: Any = None  # (T, H, W, 3) f32
    sizes: Any = None  # (T, 2) i32 true (h, w) per texture before padding
    names: dict = field(default_factory=dict)  # name -> id

    @staticmethod
    def build(images: dict, device) -> "TextureAtlas":
        """images: {name: (h, w, 3) float array} -> atlas on `device`; ids
        in sorted name order, as lucille_tpu assigns them."""
        if not images:
            return TextureAtlas()
        H = max(im.shape[0] for im in images.values())
        W = max(im.shape[1] for im in images.values())
        stack = np.zeros((len(images), H, W, 3), dtype=np.float32)
        sizes = np.zeros((len(images), 2), dtype=np.int32)
        names = {}
        for i, (name, im) in enumerate(sorted(images.items())):
            h, w = im.shape[:2]
            stack[i, :h, :w] = np.asarray(im, dtype=np.float32)[..., :3]
            sizes[i] = (h, w)
            names[name] = i
        dev = torch.device(device)
        return TextureAtlas(data=torch.from_numpy(stack).to(dev),
                            sizes=torch.from_numpy(sizes).to(dev),
                            names=names)

    def id_of(self, name: str) -> int:
        return self.names.get(name, -1)

    def fetch(self, tex_id, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Bilinear texel fetch (ri_texture_fetch, texture.c:86).

        tex_id: an int or a tensor of s's shape; s, t: f32 in [0, 1]
        (clamped: the reference's clamp addressing).  Returns
        s.shape + (3,) f32."""
        if self.data is None:
            return torch.ones(s.shape + (3,), dtype=torch.float32,
                              device=s.device)
        if torch.is_tensor(tex_id):
            tid = tex_id.to(torch.int64).expand(s.shape)
        else:  # filled on the device: a host scalar copied there would wait
            tid = torch.full(s.shape, int(tex_id), dtype=torch.int64,
                             device=s.device)
        tid = torch.clamp(tid, 0, self.data.shape[0] - 1)
        h = self.sizes[tid, 0].to(torch.float32)
        w = self.sizes[tid, 1].to(torch.float32)
        x = torch.clamp(s, 0.0, 1.0) * (w - 1.0)
        y = torch.clamp(t, 0.0, 1.0) * (h - 1.0)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        x1 = torch.minimum(x0 + 1, (w - 1.0).to(torch.int64))
        y1 = torch.minimum(y0 + 1, (h - 1.0).to(torch.int64))
        fx = (x - x0.to(torch.float32))[..., None]
        fy = (y - y0.to(torch.float32))[..., None]
        c00 = self.data[tid, y0, x0]
        c10 = self.data[tid, y0, x1]
        c01 = self.data[tid, y1, x0]
        c11 = self.data[tid, y1, x1]
        return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
                + c01 * (1 - fx) * fy + c11 * fx * fy)


def ibl_fetch_latlong(atlas: TextureAtlas, tex_id, dirn: torch.Tensor):
    """Environment fetch, lat-long projection (texture.c:238 capability).

    dirn: (B, 3) unit directions, y-up.  theta in [0, pi] downward from
    +y, phi wraps around y."""
    theta = torch.acos(torch.clamp(dirn[..., 1], -1.0, 1.0))
    phi = torch.atan2(dirn[..., 2], dirn[..., 0])
    s = (phi + math.pi) / (2.0 * math.pi)
    t = theta / math.pi
    return atlas.fetch(tex_id, s, t)


def ibl_fetch_angular(atlas: TextureAtlas, tex_id, dirn: torch.Tensor):
    """Environment fetch, Debevec angular-map projection
    (texture.h:100-105 angular->latlong capability):
    r = acos(-dz) / (pi * sqrt(dx^2 + dy^2))."""
    d = dirn
    denom = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    r = torch.where(
        denom > 1e-9,
        torch.acos(torch.clamp(-d[..., 2], -1.0, 1.0))
        / (math.pi * torch.clamp_min(denom, 1e-9)),
        0.0,
    )
    s = 0.5 + 0.5 * d[..., 0] * r
    t = 0.5 - 0.5 * d[..., 1] * r
    return atlas.fetch(tex_id, s, t)
