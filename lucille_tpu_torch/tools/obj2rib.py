"""obj2rib: convert a Wavefront OBJ to a renderable RIB scene.

The port's counterpart of tools_tpu/obj2rib.py (the DCC-exporter
counterpart of the reference's exporters/, exporters/houdini/htol.py and
tools/blender): reads the OBJ with the port's ri/wavefront.load_obj and
writes a self-contained RIB with an auto-framed camera and a ground
plane under the object, so any OBJ can go straight through
`python -m lucille_tpu_torch.cli`.  The RIB text is the original's line
for line, but for its first comment, which names the port.

    python -m lucille_tpu_torch.tools.obj2rib model.obj > model.rib
    python -m lucille_tpu_torch.tools.obj2rib model.obj -o model.rib --fov 40
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def obj_to_rib(obj_path, fov=45.0, samples=2, gather=64, method=None) -> str:
    from lucille_tpu_torch.ri.wavefront import load_obj

    geom = load_obj(obj_path)
    if geom is None:
        raise SystemExit(f"no geometry in {obj_path}")

    P = geom.positions
    bbmin, bbmax = P.min(axis=0), P.max(axis=0)
    center = 0.5 * (bbmin + bbmax)
    radius = float(np.linalg.norm(bbmax - bbmin)) * 0.5
    dist = radius / np.tan(np.deg2rad(fov) * 0.5) * 1.4

    idx = geom.indices
    nverts = " ".join("3" for _ in range(len(idx)))
    flat_idx = " ".join(str(int(i)) for i in idx.reshape(-1))
    flat_p = " ".join(f"{v:.6f}" for v in P.reshape(-1))

    out = []
    out.append("# generated by lucille_tpu_torch obj2rib")
    out.append('Display "obj_render.hdr" "file" "rgb"')
    out.append(f"PixelSamples {samples} {samples}")
    out.append(f'Projection "perspective" "fov" [{fov}]')
    out.append('Orientation "rh"')
    # camera: looking at the bbox center from +z, slightly above
    eye = center + np.array([0.0, radius * 0.5, dist])
    out.append(
        "ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  "
        f"{-eye[0]:.6f} {-eye[1]:.6f} {-eye[2]:.6f} 1]"
    )
    if method:
        out.append(f'Option "renderer" "method" ["{method}"]')
    out.append(f'Option "raytrace" "finalgather_rays" [{gather}]')
    out.append("WorldBegin")
    # ground plane under the object
    g = bbmin[1]
    s = radius * 4
    out.append(
        f'PointsPolygons [4] [0 3 2 1] "P" '
        f"[{center[0]-s:.4f} {g:.4f} {center[2]-s:.4f}  "
        f"{center[0]+s:.4f} {g:.4f} {center[2]-s:.4f}  "
        f"{center[0]+s:.4f} {g:.4f} {center[2]+s:.4f}  "
        f"{center[0]-s:.4f} {g:.4f} {center[2]+s:.4f}]"
    )
    out.append("AttributeBegin")
    out.append(f"PointsPolygons [{nverts}] [{flat_idx}] \"P\" [{flat_p}]")
    out.append("AttributeEnd")
    out.append("WorldEnd")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("obj")
    ap.add_argument("-o", "--out", help="output RIB (default stdout)")
    ap.add_argument("--fov", type=float, default=45.0)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--gather", type=int, default=64)
    ap.add_argument("--method", help="renderer method option")
    a = ap.parse_args(argv)
    rib = obj_to_rib(a.obj, a.fov, a.samples, a.gather, a.method)
    if a.out:
        with open(a.out, "w") as f:
            f.write(rib)
        print(f"wrote {a.out}", file=sys.stderr)
    else:
        sys.stdout.write(rib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
