"""Per-tile AO jitter: the renderer's sampler seam.

The AO kernel takes its per-lane uniforms as an input (as the TPU kernel
does, pallas_ao.py:597-606).  The renderer asks a sampler for them once
per tile: ``sampler(x0, y0, n) -> (2, n) f32`` on the render device.

`TileSampler` is the default.  Its generator is re-seeded for every tile
from (seed, x0, y0), so a tile's jitter depends on the tile's origin and
not on the order tiles are rendered in: a cropped render gives the same
pixels as the full one.  Tests substitute a sampler that returns the JAX
package's own draw to compare frames lane for lane.
"""

from __future__ import annotations

import numpy as np
import torch


class TileSampler:
    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def __call__(self, x0: int, y0: int, n: int) -> torch.Tensor:
        hi, lo = np.random.SeedSequence(
            [self.seed, int(x0), int(y0)]
        ).generate_state(2, np.uint32)
        self.generator.manual_seed((int(hi) << 32 | int(lo)) >> 1)
        return torch.rand((2, n), generator=self.generator,
                          device=self.device, dtype=torch.float32)
