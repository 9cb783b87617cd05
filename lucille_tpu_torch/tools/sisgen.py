"""sisgen: the Structured Importance Sampling preprocessor's command line.

The port's counterpart of tools_tpu/sisgen.py:106-125 (the successor of
the reference's tools/sis; Agarwal, Ramamoorthi, Belongie, Jensen,
"Structured Importance Sampling of Environment Maps", SIGGRAPH 2003):
loads a lat-long environment map through the port's imageio/loader,
places its structured samples with lights/sisgen.generate_sis_samples
(the same NumPy code and seed as the original), and writes the .npz
that a `structured` light's "sisfile" names (dirs (S, 3), rgb (S, 3);
lights/envmap.EnvMap.load_sis reads it), plus an optional text dump
(dir xyz, two spaces, rgb; one sample a line).  The same flags, files
and printed lines as the original.  Generating the samples once here
spares a Renderer the seconds it takes at the first frame (a 2048x1024
map: seconds of NumPy).

    python -m lucille_tpu_torch.tools.sisgen sky.hdr [-n 64]
        [-o gensamples.npz] [--text gensamples.txt]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("envmap", help="lat-long .hdr environment map")
    ap.add_argument("-n", "--nsamples", type=int, default=64)
    ap.add_argument("-o", "--out", default="gensamples.npz")
    ap.add_argument("--text", help="also write a text dump (dir xyz + rgb)")
    a = ap.parse_args(argv)

    from lucille_tpu_torch.imageio.loader import load_image
    from lucille_tpu_torch.lights.sisgen import generate_sis_samples

    img = load_image(a.envmap)
    dirs, rgb = generate_sis_samples(img, a.nsamples)
    np.savez(a.out, dirs=dirs, rgb=rgb)
    print(f"wrote {a.out}: {len(dirs)} structured samples")
    if a.text:
        with open(a.text, "w") as f:
            for d, c in zip(dirs, rgb):
                f.write(f"{d[0]} {d[1]} {d[2]}  {c[0]} {c[1]} {c[2]}\n")
        print(f"wrote {a.text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
