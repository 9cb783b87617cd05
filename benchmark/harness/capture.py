"""One frame's kernel inputs, recorded for the rooflines.

After the traced frames, the run renders the first traced frame again
(the same frame seed, so the same inputs) with recorders around the
port's launch functions of the dense AO gather
(`accel.ao.ao_occlusion_kernel`, kernels 3 and 3b) and the tile-BVH
any-hit (`accel.bvh_isect.bvh_any_hit`, kernel 5).  Each recorder passes
the call through unchanged and keeps what the need counts read: the AO
gather's compacted rays, jitter and live count (a device tensor, read
after the frame), the any-hit's N_NEED rays drawn with a fixed seed, as
chip_smoke.py draws them.  A launch function the program no longer has
records nothing, and its roofline reads nothing.
"""

from __future__ import annotations

from contextlib import contextmanager

from harness.need import N_NEED


@contextmanager
def recording(captures: dict):
    import torch

    from lucille_tpu_torch.accel import ao, bvh_isect

    saved = []

    def wrap(mod, name, record):
        orig = getattr(mod, name, None)
        if orig is None:
            return

        def recorder(*args, **kwargs):
            out = orig(*args, **kwargs)
            record(*args, **kwargs)
            return out

        saved.append((mod, name, orig))
        setattr(mod, name, recorder)

    def ao_record(scene, rays, jitter, nact, ntheta, nphi, want_bits=False,
                  counters=False):
        captures.setdefault("ao_gather", []).append(
            {"scene": scene, "rays": rays, "jitter": jitter, "nact": nact,
             "ntheta": ntheta, "nphi": nphi, "want_bits": want_bits})

    def any_record(tris, nodes, org, dirn, tmax=None, *, depth, **_kw):
        R = org.shape[0]
        gen = torch.Generator(device=org.device).manual_seed(11)
        sample = torch.randperm(R, device=org.device, generator=gen)[:N_NEED]
        captures.setdefault("bvh_anyhit", []).append(
            {"tris": tris, "nodes": nodes, "org": org[sample],
             "dirn": dirn[sample], "rays": R, "depth": depth,
             "bounded": tmax is not None})

    wrap(ao, "ao_occlusion_kernel", ao_record)
    wrap(bvh_isect, "bvh_any_hit", any_record)
    try:
        yield captures
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
