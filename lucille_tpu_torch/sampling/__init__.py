"""Sampling: quasi-Monte-Carlo sequences, Latin hypercubes and the random
streams.

Counterpart of lucille_tpu/sampling:

- src/render/qmc.c: Halton, Faure permutations, generalized scrambled
  Halton / Hammersley, Fibonacci lattice -> `sampling.qmc`;
- src/render/render.c:830-917: Keller's sigma-permuted two-dimensional
  Hammersley subpixel samples -> `sampling.hammersley`;
- src/render/mc.c: the Latin hypercube -> `sampling.mc`;
- src/base/random.c: per-thread MT19937 streams -> `sampling.rng` and
  `sampling.jitter` (a stream per tile, a draw named by its fold-in
  path; parity with lucille_tpu is in distribution, not bit for bit).
"""

from lucille_tpu_torch.sampling.hammersley import SigmaTable, subpixel_samples
from lucille_tpu_torch.sampling.mc import latin_hypercube
from lucille_tpu_torch.sampling.qmc import (
    faure_permutations,
    fibonacci_lattice,
    generalized_hammersley,
    halton,
    radical_inverse,
)
from lucille_tpu_torch.sampling.rng import fold_in_many, pixel_key

__all__ = [
    "SigmaTable",
    "subpixel_samples",
    "radical_inverse",
    "halton",
    "faure_permutations",
    "generalized_hammersley",
    "fibonacci_lattice",
    "latin_hypercube",
    "pixel_key",
    "fold_in_many",
]
