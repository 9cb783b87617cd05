"""Structured importance sampling of environment maps.

The port's copy of `generate_sis_samples` from tools_tpu/sisgen.py:36-105
(the successor of the reference's tools/sis; Agarwal, Ramamoorthi,
Belongie, Jensen, "Structured Importance Sampling of Environment Maps",
SIGGRAPH 2003): the same NumPy code, `default_rng(seed)` and Lloyd
relaxation, with `latlong_directions` from the port's lights/ibl.py.
The port may not import tools_tpu, whose sisgen imports lucille_tpu.

1. importance metric per texel: L * dOmega^{1/4};
2. luminance layers by thresholds L_i = L_max / 4^i;
3. within each layer, samples allocated by total importance and placed by
   k-means (Lloyd) relaxation on the sphere, seeded by importance-
   weighted picks;
4. each sample's radiance weight is the summed radiance * dOmega of the
   texels in its Voronoi cell: energy is exactly partitioned.
"""

from __future__ import annotations

import numpy as np

from lucille_tpu_torch.lights.ibl import latlong_directions


def generate_sis_samples(image: np.ndarray, nsamples: int = 64, nlayers: int = 6,
                         lloyd_iters: int = 8, seed: int = 0):
    """Return (dirs (S, 3), rgb (S, 3)) structured samples for a lat-long
    environment image."""
    img = np.asarray(image, dtype=np.float64)
    h, w = img.shape[:2]
    dirs, solid = latlong_directions(h, w)
    dirs = dirs.reshape(-1, 3)
    solid = solid.reshape(-1)
    rgb = img.reshape(-1, 3)
    lum = rgb.mean(axis=-1)

    importance = lum * np.power(np.maximum(solid, 1e-12), 0.25)
    total_imp = importance.sum()
    if total_imp <= 0:
        return np.zeros((0, 3)), np.zeros((0, 3))

    # luminance layers: L_max / 4^i thresholds
    lmax = lum.max()
    layer_of = np.zeros(len(lum), dtype=np.int64)
    for i in range(1, nlayers):
        layer_of[lum < lmax / (4.0**i)] = i

    rng = np.random.default_rng(seed)
    all_dirs = []
    all_centers_idx = []
    for layer in range(nlayers):
        mask = layer_of == layer
        if not mask.any():
            continue
        imp = importance[mask]
        frac = imp.sum() / total_imp
        k = max(1, int(round(nsamples * frac))) if frac > 1e-6 else 0
        if k == 0:
            continue
        idx = np.nonzero(mask)[0]
        # importance-weighted seeding
        p = imp / imp.sum()
        seeds = rng.choice(len(idx), size=min(k, len(idx)), replace=False, p=p)
        centers = dirs[idx[seeds]]
        # Lloyd relaxation within the layer
        ld = dirs[idx]
        lw = imp
        for _ in range(lloyd_iters):
            sim = ld @ centers.T  # cosine similarity
            assign = sim.argmax(axis=1)
            for c in range(len(centers)):
                m = assign == c
                if m.any():
                    v = (ld[m] * lw[m, None]).sum(axis=0)
                    n = np.linalg.norm(v)
                    if n > 1e-12:
                        centers[c] = v / n
        all_dirs.append(centers)
        all_centers_idx.append(idx)

    if not all_dirs:
        return np.zeros((0, 3)), np.zeros((0, 3))
    centers = np.concatenate(all_dirs)

    # energy partition: each texel's radiance*solid goes to its nearest center
    sim = dirs @ centers.T
    assign = sim.argmax(axis=1)
    weights = np.zeros((len(centers), 3))
    np.add.at(weights, assign, rgb * solid[:, None])
    return centers.astype(np.float32), weights.astype(np.float32)
