"""Per-tile random streams: the renderer's sampler seam.

lucille_tpu's integrators draw every random number from the tile's key
through `jax.random.fold_in` chains: AO's gather jitter is
uniform(key, (2, B)), Whitted's dome gather uniform(fold_in(fold_in(key,
depth), i + 1000), (2, B)), the path tracer's bounce uniform(fold_in(
fold_in(key, depth), 99), (B, 2)).  The port names a draw by that chain:
a tile's stream answers

    stream.uniform(path, shape)        -> f32 uniforms in [0, 1)
    stream.randint(path, shape, high)  -> i64 integers in [0, high)

where `path` is the tuple of fold-in integers below the tile's key (the
empty tuple for the tile's own draw).  The renderer asks its sampler for
one stream per tile, ``sampler(x0, y0) -> stream``.

`TileSampler` is the default.  Its stream re-seeds one `torch.Generator`
on the device from (seed, x0, y0, *path) for every draw, so a draw
depends on the tile's origin and on its path alone, not on the order
tiles or draws are made in: a cropped render gives the same pixels as the
full one, and the empty path gives the AO jitter the port drew before
streams had paths.  Tests substitute streams that answer with the JAX
package's own draws for the same chains, to compare frames lane for lane.
"""

from __future__ import annotations

import numpy as np
import torch


class TileStream:
    """The default stream of one tile (see the module docstring)."""

    def __init__(self, seed: int, x0: int, y0: int, generator):
        self.key = (int(seed), int(x0), int(y0))
        self.generator = generator

    def _seed(self, path) -> torch.Generator:
        hi, lo = np.random.SeedSequence(
            [*self.key, *(int(p) for p in path)]
        ).generate_state(2, np.uint32)
        return self.generator.manual_seed((int(hi) << 32 | int(lo)) >> 1)

    def uniform(self, path, shape) -> torch.Tensor:
        gen = self._seed(path)
        return torch.rand(tuple(shape), generator=gen, device=gen.device,
                          dtype=torch.float32)

    def randint(self, path, shape, high: int) -> torch.Tensor:
        gen = self._seed(path)
        return torch.randint(int(high), tuple(shape), generator=gen,
                             device=gen.device)


class TileSampler:
    """sampler(x0, y0) -> the TileStream of the tile at (x0, y0)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def __call__(self, x0: int, y0: int) -> TileStream:
        return TileStream(self.seed, x0, y0, self.generator)


class HostStream:
    """A tile's stream drawn by numpy on the host from (seed, x0, y0,
    *path) and copied to the device: the same numbers on every device,
    so a frame on the card can be held against the same frame on the
    CPU.  Slower than TileStream (a host draw and a copy per draw)."""

    def __init__(self, seed: int, x0: int, y0: int, device):
        self.key = (int(seed), int(x0), int(y0))
        self.device = torch.device(device)

    def _rng(self, path) -> np.random.Generator:
        return np.random.default_rng([*self.key, *(int(p) for p in path)])

    def uniform(self, path, shape) -> torch.Tensor:
        u = self._rng(path).random(tuple(shape), dtype=np.float32)
        return torch.from_numpy(u).to(self.device)

    def randint(self, path, shape, high: int) -> torch.Tensor:
        i = self._rng(path).integers(0, int(high), tuple(shape))
        return torch.from_numpy(i).to(self.device)


class HostSampler:
    """sampler(x0, y0) -> the HostStream of the tile at (x0, y0)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def __call__(self, x0: int, y0: int) -> HostStream:
        return HostStream(self.seed, x0, y0, self.device)


class StreamKey:
    """A point of a tile's fold-in chain: what a `jax.random` key is to
    lucille_tpu's integrators.  key.fold(i) is fold_in(key, i);
    key.uniform(shape) and key.randint(shape, high) draw at the chain's
    path from the tile's stream."""

    def __init__(self, stream, path=()):
        self.stream = stream
        self.path = tuple(int(p) for p in path)

    def fold(self, i: int) -> "StreamKey":
        return StreamKey(self.stream, self.path + (int(i),))

    def uniform(self, shape) -> torch.Tensor:
        return self.stream.uniform(self.path, shape)

    def randint(self, shape, high: int) -> torch.Tensor:
        return self.stream.randint(self.path, shape, high)
