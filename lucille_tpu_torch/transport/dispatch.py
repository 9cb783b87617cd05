"""Integrator dispatch by render method.

Counterpart of lucille_tpu/transport/dispatch.py:18-35.  The port has
the AO integrator only (the reference's hardwired default, render.c:803);
every other method raises.

Contract: fn(scene, lights, org, dirn, jitter, *, gather_nsamples) ->
(radiance (B, 3), aux), as lucille_tpu's fn(scene, lights, org, dirn,
key, ...) with the (2, B) jitter in place of the key.
"""

from __future__ import annotations

import math

from lucille_tpu_torch.transport.ao import ao_radiance

AO_NAMES = ("ao", "ambientocclusion", "mcraytrace", "default", "")


def get_integrator(name: str):
    name = (name or "").lower()
    if name not in AO_NAMES:
        raise NotImplementedError(
            f"render method {name!r} is not ported; the port renders AO only "
            "(ROADMAP Queue 1: shading wavefronts)"
        )

    def ao_fn(scene, lights, org, dirn, jitter, *, gather_nsamples: int = 64):
        ntheta = max(1, int(math.sqrt(gather_nsamples)))
        return ao_radiance(scene, org, dirn, jitter, ntheta, ntheta,
                           lights=lights)

    return ao_fn
