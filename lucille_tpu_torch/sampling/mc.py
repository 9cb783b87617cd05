"""Monte-Carlo sampling helpers: Latin hypercube.

Counterpart of lucille_tpu/sampling/mc.py, the capability of lucille's
src/render/mc.c (`ri_mc_lhs`, mc.c:48): n stratified samples in every
dimension, a random permutation of the strata decorrelating the
dimensions.  Drawn from an explicit `torch.Generator` where lucille_tpu
splits a `jax.random` key: deterministic under the generator's seed, not
the same numbers.
"""

from __future__ import annotations

import torch


def latin_hypercube(generator: torch.Generator, n: int,
                    dim: int) -> torch.Tensor:
    """(n, dim) f32 Latin-hypercube samples in [0, 1) on the generator's
    device: column d holds one sample in each stratum [k / n, (k + 1) / n)."""
    dev = generator.device
    jitter = torch.rand((n, dim), generator=generator, device=dev)
    cols = []
    for d in range(dim):
        perm = torch.randperm(n, generator=generator, device=dev)
        cols.append((perm.to(torch.float32) + jitter[:, d]) / n)
    return torch.stack(cols, dim=-1)
