"""Fur demo: a patch of Bezier hair strands rendered with AO.

The port's counterpart of examples_tpu/fur.py (the scene shape of the
reference's FurRender R&D renderer, rnd/FurRender/main.cpp: Bezier
strands over a ground plane, on the production pipeline): the strands
tessellate to tubes (ri/curves.py) and trace through the same kernels as
every other triangle.  At the defaults, 400 strands at 320x240, that is
25,602 triangles, above the dense accel's 16,384, so the frame runs on
the tile BVH (its closest hit and the cone gather's any-hit); 40 strands
(2,562 triangles) stay on the dense tiles.

`make_rib` writes the original's RIB text, character for character.
Its "width" array has one value per vertex of ONE strand, and
ri/curves.py (the reference's, copied) drops a width array that is not
per-vertex over all strands after the first strand's worth: only the
first strand tapers (0.05 -> 0.005), every other takes the default
constant width (0.01).  That fault is kept, so the two packages' frames compare.

    python -m lucille_tpu_torch.examples.fur [--strands 400]
        [--out fur.hdr] [--size 320 240] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def make_rib(out: str, nstrands: int, seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    curves, nv = [], []
    for _ in range(nstrands):
        x, z = rng.uniform(-2.0, 2.0, 2)
        lean = rng.uniform(-0.5, 0.5, 2)
        h = rng.uniform(1.2, 2.0)
        cp = np.array(
            [
                [x, 0.0, z],
                [x + 0.25 * lean[0], 0.4 * h, z + 0.25 * lean[1]],
                [x + 0.7 * lean[0], 0.75 * h, z + 0.7 * lean[1]],
                [x + lean[0], h, z + lean[1]],
            ]
        )
        curves.append(cp)
        nv.append(4)
    P = " ".join(f"{v:.4f}" for v in np.concatenate(curves).reshape(-1))
    nvs = " ".join(str(v) for v in nv)
    return (
        f'Display "{out}" "file" "rgb"\n'
        "PixelSamples 2 2\n"
        'Projection "perspective" "fov" [45]\n'
        'Orientation "rh"\n'
        "ConcatTransform [1 0 0 0  0 0.9397 0.342 0 "
        "0 -0.342 0.9397 0  0 -0.6 -7 1]\n"
        "WorldBegin\n"
        'PointsPolygons [4] [0 3 2 1] "P" '
        "[-4 0 -4  4 0 -4  4 0 4  -4 0 4]\n"
        f'Curves "cubic" [{nvs}] "nonperiodic" "P" [{P}] '
        '"width" [0.05 0.04 0.02 0.005]\n'
        "WorldEnd\n"
    )


def fur_state(nstrands: int = 400, size=(320, 240), out: str = "fur.hdr",
              seed: int = 7):
    """The example's scene as the port's RiState: make_rib's text parsed
    by the port's front end, at size (width, height)."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib

    s = RiState()
    parse_rib(make_rib(out, nstrands, seed), s)
    s.Format(*size)
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strands", type=int, default=400)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "fur.hdr"))
    ap.add_argument("--size", type=int, nargs=2, default=(320, 240))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lucille_tpu_torch.imageio.loader import save_image
    from lucille_tpu_torch.render.renderer import Renderer

    s = fur_state(args.strands, args.size, args.out)
    ntris = sum(g.ntriangles for g in s.scene.geoms)
    print(f"{args.strands} strands -> {ntris} triangles")
    r = Renderer(s.scene, tile_size=128, device=args.device)
    t0 = time.perf_counter()
    img = r.render_frame()
    print(
        f"rendered {args.size[0]}x{args.size[1]} in "
        f"{time.perf_counter() - t0:.2f}s "
        f"({r.stats.nrays / max(r.stats.render_seconds, 1e-9) / 1e6:.1f} "
        "Mrays/s)"
    )
    save_image(args.out, np.asarray(img))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
