"""The benchmark's inputs, made from a configuration and a traffic mix:
the scene the program renders (through the port's own RIB parser and Ri
API, as a user's scene reaches it) and the same raw input for the plain
reference (its own RIB reader, the same terrain arrays).

The scene functions are frozen copies of chip_smoke.py at commit d8e7cf1:
`bundled_state` (:454-485) and `heightfield_grid` / `heightfield_state`
(:488-538), cut to what the configurations use.

A configuration (configs/<name>.json) gives the scene:

- "scene": "rib": the RIB file "rib" beside it;
- "scene": "heightfield": bench_large's analytic terrain of n x n
  vertices under the camera of RIB text "camera", handed to
  RiPointsPolygons as one mesh;

and the frame: "xres", "yres", "pixel_samples", "gather_rays".  The
port picks the accel as a user's RIB leaves it ("auto": its dense tiles
up to 16,384 triangles, the tile BVH above).  A traffic mix
(traffic/<name>.json) gives what is rendered: "method", "tile" and
"light" ("as_shipped" keeps the RIB's lights, "none" removes its
AreaLightSource lines).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def heightfield_grid(n: int):
    """bench_large.heightfield_scene's analytic terrain: ((n*n, 3) f32
    vertices, ((n-1)^2, 4) i64 quads)."""
    i = np.arange(n, dtype=np.float32)
    x = -5.0 + 10.0 * i / (n - 1)
    xx, zz = np.meshgrid(x, x)  # zz varies along rows, as in bench_large_driver.c
    yy = 0.5 * np.sin(1.3 * xx) * np.cos(1.1 * zz) + 0.25 * np.sin(
        2.7 * xx + 1.0
    ) * np.sin(1.9 * zz)
    P = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    jj, ii = np.meshgrid(
        np.arange(n - 1, dtype=np.int64), np.arange(n - 1, dtype=np.int64),
        indexing="ij",
    )
    a = jj * n + ii
    quads = np.stack([a, a + 1, a + n + 1, a + n], axis=-1).reshape(-1, 4)
    return P, quads


def rib_text(config: dict, traffic: dict) -> str:
    """The configuration's RIB, its AreaLightSource lines removed where
    the traffic asks for no light."""
    text = (Path(config["dir"]) / config["rib"]).read_text()
    if traffic.get("light", "as_shipped") == "none":
        text = "".join(l for l in text.splitlines(keepends=True)
                       if not l.lstrip().startswith("AreaLightSource"))
    return text


def program_scene(config: dict, traffic: dict):
    """The port's RiState for the cell, its options set as a user's RIB
    or command line would set them."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib

    s = RiState()
    if config["scene"] == "rib":
        parse_rib(rib_text(config, traffic), s)
        s.Format(config["xres"], config["yres"])
    elif config["scene"] == "heightfield":
        P, quads = heightfield_grid(config["n"])
        parse_rib(config["camera"], s)
        s.Format(config["xres"], config["yres"])
        s.WorldBegin()
        s.AttributeBegin()
        s.Transform(np.eye(4).reshape(-1))
        s.PointsPolygons(np.full(len(quads), 4, np.int64),
                         quads.reshape(-1), {"P": P})
        s.AttributeEnd()
        s.WorldEnd()
    else:
        raise ValueError(f"unknown scene kind {config['scene']!r}")
    ps = config["pixel_samples"]
    s.PixelSamples(ps, ps)
    s.options.gather_nsamples = config["gather_rays"]
    s.options.render_method = traffic["method"]
    return s


def reference_scene(config: dict, traffic: dict):
    """(the reference's Scene, its Frame) from the same raw input."""
    from reference import ao
    from reference.rib import points_polygons, read_rib

    if config["scene"] == "rib":
        rs = read_rib(rib_text(config, traffic))
        scene = ao.Scene(*rs.triangles())
    else:
        n = config["n"]
        P, quads = heightfield_grid(n)
        rs = read_rib(config["camera"])
        points_polygons(rs, [4] * len(quads), quads.reshape(-1).tolist(), P,
                        np.eye(4))
        scene = ao.GridScene(*rs.triangles(), n)
    cam = ao.Camera.make(rs.fov, rs.rh, rs.world_to_camera, config["xres"],
                         config["yres"])
    side = int(round(np.sqrt(config["gather_rays"])))
    if side * side != config["gather_rays"]:
        raise ValueError("gather_rays must be a square (ntheta = nphi)")
    ps = config["pixel_samples"]
    sky = None
    if rs.sunsky is not None:
        from reference.sunsky import PreethamSunSky

        sky = PreethamSunSky(**rs.sunsky)
    return scene, ao.Frame(cam, ps, ps, side, side, traffic["tile"],
                           sky=sky, method=traffic["method"])
