"""The random numbers of a tile, drawn again as the port's default tile
stream draws them: for every draw a `torch.Generator` on the device is
seeded from numpy's SeedSequence over (seed, x0, y0, *path), its first
two 32-bit words joined and halved, and torch.rand draws float32
uniforms of the draw's shape from it."""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, x0: int, y0: int, path=()) -> int:
    hi, lo = np.random.SeedSequence(
        [int(seed), int(x0), int(y0), *(int(p) for p in path)]
    ).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) >> 1


def tile_uniform(seed: int, x0: int, y0: int, path, shape,
                 device) -> torch.Tensor:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, x0, y0, path))
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)
