"""BVH visualizer: traversal-cost heatmaps and node-box wireframes.

The port's counterpart of tools_tpu/bvh_viz.py (the headless analogue of
the reference testbed's BVHVisualizer.cpp and of the diagnostics behind
RI_BVH_ENABLE_DIAGNOSTICS, bvh.h:95-104): the scene's tile BVH walked
ray by ray from the scene camera (accel/traverse.bvh_diag), one ray a
pixel through its centre, and

    python -m lucille_tpu_torch.tools.bvh_viz scene.rib -o heat.hdr
    python -m lucille_tpu_torch.tools.bvh_viz scene.rib --boxes nodes.obj
    python -m lucille_tpu_torch.tools.bvh_viz scene.rib --metric ntris

writes the per-pixel node visits (or leaf visits, or triangle tests)
through a blue-to-red ramp, and every node's box as 12 OBJ line segments
(leaves only with --leaves).  --device cuda (the default) or cpu.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def heatmap(values, lo=None, hi=None):
    """(H, W) scalar -> (H, W, 3) blue -> cyan -> yellow -> red ramp."""
    v = values.astype(np.float64)
    lo = float(v.min()) if lo is None else lo
    hi = float(v.max()) if hi is None else hi
    x = np.clip((v - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def render_diag(rib_path, width=None, height=None, metric="nvisits",
                device="cuda"):
    """(the metric's (H, W) array, {nvisits, nleafs, ntris: (H, W)}, the
    compiled scene) of the RIB's scene, its tile BVH built whatever its
    accel request."""
    from lucille_tpu_torch.accel.traverse import bvh_diag
    from lucille_tpu_torch.device import resolve_device
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.ri.camera import generate_rays
    from lucille_tpu_torch.rib.parser import parse_rib_file
    from lucille_tpu_torch.scene.compile import compile_scene

    dev = resolve_device(device)
    state = RiState()
    parse_rib_file(rib_path, state)
    if width or height:
        state.Format(width or state.options.width,
                     height or state.options.height)
    W, H = state.options.width, state.options.height
    scene = compile_scene(state.scene, dev, build_bvh=True)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    org, dirn = generate_rays(state.camera, xs.reshape(-1), ys.reshape(-1))
    d = bvh_diag(scene, org.contiguous(), dirn.contiguous())
    stats = {k: d[k].cpu().numpy().reshape(H, W)
             for k in ("nvisits", "nleafs", "ntris")}
    return stats[metric], stats, scene


def dump_boxes_obj(scene, path, leaves_only=False):
    """Write the tree's node boxes as OBJ line segments."""
    bbmin = scene.node_bbmin.cpu().numpy()
    bbmax = scene.node_bbmax.cpu().numpy()
    count = scene.node_count.cpu().numpy()
    edges = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6), (6, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    with open(path, "w") as f:
        f.write("# BVH node boxes (lucille_tpu_torch bvh_viz)\n")
        vi = 1
        for i in range(scene.n_nodes):
            if leaves_only and count[i] == 0:
                continue
            lo, hi = bbmin[i], bbmax[i]
            for k in range(8):
                c = (hi[0] if k & 1 else lo[0], hi[1] if k & 2 else lo[1],
                     hi[2] if k & 4 else lo[2])
                f.write(f"v {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
            for a, b in edges:
                f.write(f"l {vi + a} {vi + b}\n")
            vi += 8
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description="BVH traversal visualizer")
    p.add_argument("rib")
    p.add_argument("-o", "--output", default="bvh_heat.hdr")
    p.add_argument("--metric", choices=["nvisits", "nleafs", "ntris"],
                   default="nvisits")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--boxes", help="also dump node AABBs to this OBJ file")
    p.add_argument("--leaves", action="store_true",
                   help="only leaf boxes in the OBJ dump")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    img_stat, _stats, scene = render_diag(args.rib, args.width, args.height,
                                          args.metric, args.device)
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    write_hdr(args.output, heatmap(img_stat)[::-1])
    print(f"{args.output}: {args.metric} min {img_stat.min()} max "
          f"{img_stat.max()} mean {img_stat.mean():.1f}")
    if args.boxes:
        dump_boxes_obj(scene, args.boxes, leaves_only=args.leaves)
        print(f"{args.boxes}: {scene.n_nodes} node boxes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
