"""What decides `correct`: sampled pixels of frames the window rendered,
against the plain reference.

Frames are drawn from the run's seed by reservoir sampling over every
frame the window completed (each frame equally likely), plus the last
one; pixels of each drawn frame are drawn from the seed too, over the
whole image, so every tile is in the sample.  Each drawn pixel is worked
out again by the reference (reference/ao.py) from the raw scene and the
frame's seed, and a pixel is off when the program's value and the
reference's differ by more than `pixel_tol` in any channel.  The numbers
compared, each with its limit (the traffic mix's "check"):

- px_off: the share of drawn pixels that are off;
- failed_frames: frames that raised or were not finite (limit 0).
"""

from __future__ import annotations

import numpy as np

# frame k of a run draws its random numbers with the seed
# frame_seed(run seed, k); frame 0 is the warm frame
FRAME_STRIDE = 1 << 16


def frame_seed(seed: int, k: int) -> int:
    return int(seed) * FRAME_STRIDE + int(k)


class FrameSample:
    """A seeded reservoir of `size` frames, plus the last frame seen."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([int(seed), 101])
        self.size = size
        self.kept = []  # [(k, image)]
        self.seen = 0
        self.last = None

    def offer(self, k: int, image) -> None:
        self.seen += 1
        self.last = (k, image)
        if len(self.kept) < self.size:
            self.kept.append((k, image))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.kept[j] = (k, image)

    def frames(self):
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


def draw_pixels(seed: int, k: int, width: int, height: int, n: int):
    """n distinct raster pixels (x, y) of frame k, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 202, int(k)])
    flat = rng.choice(width * height, size=min(n, width * height),
                      replace=False)
    return np.stack([flat % width, flat // width], axis=1)


def pixels_off(got, ref, check) -> int:
    """How many pixels (rows of (P, 3)) differ by more than pixel_tol +
    pixel_rtol x |reference| in some channel."""
    lim = check["pixel_tol"] + check.get("pixel_rtol", 0.0) * np.abs(ref)
    return int((np.abs(got - ref) > lim).any(axis=1).sum())


def compare(frames, seed: int, scene, frame, check: dict, device) -> dict:
    """px_off over the drawn pixels of `frames` [(k, image)]: the share
    `pixels_off` counts against the float32 reference."""
    from reference import render_pixels

    cache = {}
    off = total = 0
    for k, image in frames:
        pix = draw_pixels(seed, k, frame.width, frame.height, check["pixels"])
        ref = render_pixels(scene, frame, frame_seed(seed, k), pix, device,
                            cache=cache)
        got = np.asarray(image, np.float64)[pix[:, 1], pix[:, 0]]
        off += pixels_off(got, ref, check)
        total += len(pix)
    return {"px_off": off / max(total, 1), "pixels": total}
