"""Random-stream discipline: a stream per (frame, pixel, sample, bounce).

Counterpart of lucille_tpu/sampling/rng.py.  The reference draws from
per-thread MT19937 streams (src/base/random.c:211, `randomMT2(thread_id)`);
lucille_tpu folds a threefry key over the logical coordinates.  The port
names a draw by the same fold-in chain (sampling/jitter.py): a StreamKey
is a stream and a path of integers, `key.fold(i)` extends the path, and
the default stream re-seeds one `torch.Generator` from (seed, x0, y0,
*path) for every draw.  So a key folded over (frame, x, y) gives every
pixel of every frame its own reproducible stream, independent of the
order in which pixels or tiles are drawn.  The bits are not threefry's:
parity with lucille_tpu is in distribution, not bit for bit.
"""

from __future__ import annotations

import torch

from lucille_tpu_torch.sampling.jitter import StreamKey, TileStream


def base_key(seed: int, device) -> StreamKey:
    """The root key of a render: the default stream of `seed` (the tile
    origin (0, 0)), on `device`, with an empty path."""
    return StreamKey(TileStream(seed, 0, 0,
                                torch.Generator(device=torch.device(device))))


def pixel_key(base: StreamKey, x: int, y: int, frame: int = 0) -> StreamKey:
    """A per-pixel key from integer raster coordinates: base folded over
    frame, x, y (lucille_tpu's pixel_key)."""
    return fold_in_many(base, frame, x, y)


def fold_in_many(key: StreamKey, *data: int) -> StreamKey:
    """Fold several integers into a key (pixel, subsample, bounce, ...)."""
    for d in data:
        key = key.fold(d)
    return key
