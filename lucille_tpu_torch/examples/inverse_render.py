"""Inverse rendering: recover material parameters from a target image.

The port's counterpart of examples_tpu/inverse_render.py: render a target
with known materials, perturb them, and run Adam on the L2 pixel loss;
the gradients reach each geometry's kd and colour through the path
tracer (lucille_tpu_torch.diff), `torch.optim.Adam` in place of optax.

    python -m lucille_tpu_torch.examples.inverse_render [--steps 80]
        [--size 48] [--out /tmp/inverse_render] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

SCENE_RIB = (
    'Projection "perspective" "fov" [45]\nOrientation "rh"\n'
    "ConcatTransform [1 0 0 0  0 1 0 0  0 0 1 0  0 -2 -8 1]\n"
    "WorldBegin\n"
    'LightSource "domelight" 1 "intensity" [1.0]\n'
    'PointsPolygons [4] [0 3 2 1] "P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]\n'
    "AttributeBegin\nColor [0.9 0.4 0.2]\n"
    'PointsPolygons [3] [0 1 2] "P" [-1 0.5 -1  1 0.5 -1  0 2.5 0]\n'
    "AttributeEnd\nWorldEnd\n"
)
TRUE_KD = (0.35, 0.9)
TRUE_COLOR = ((1.0, 1.0, 1.0), (0.2, 0.5, 0.9))


def setup(width: int, height: int, device, spp: int = 4,
          max_depth: int = 3, accel: str = "auto"):
    """The example's scene (a ground quad and a coloured triangle under
    the constant dome) as (render_fn, params) of diff.differentiable_render
    on `device`, path traced."""
    from lucille_tpu_torch.device import resolve_device
    from lucille_tpu_torch.diff.render import differentiable_render
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.scene.compile import compile_scene

    dev = resolve_device(device)
    s = RiState()
    parse_rib(SCENE_RIB, s)
    s.Format(width, height)
    s.camera.setup(s.world_to_camera, s.options.orientation)
    s.options.accel_method = accel
    scene = compile_scene(s.scene, dev)
    lights = build_light_tables(s.scene, device=dev)
    return differentiable_render(scene, lights, s.camera, width, height,
                                 spp=spp, max_depth=max_depth)


def recover(render_fn, params, target, stream, theta: dict, steps: int,
            lr: float = 0.05, log=None):
    """Adam on the L2 loss between render_fn({**params, **theta}, stream)
    and target, each parameter clipped to [0, 1] after a step.  Returns
    (theta, the loss before each step)."""
    theta = {k: v.detach().clone().requires_grad_(True)
             for k, v in theta.items()}
    opt = torch.optim.Adam(theta.values(), lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        img = render_fn({**params, **theta}, stream)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for v in theta.values():
                v.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
        if log is not None:
            log(i, losses[-1])
    return {k: v.detach() for k, v in theta.items()}, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--out", default="/tmp/inverse_render")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    from lucille_tpu_torch.imageio.rgbe import write_hdr
    from lucille_tpu_torch.sampling.jitter import TileSampler

    W, H = a.size, a.size * 3 // 4
    render_fn, params = setup(W, H, a.device)
    dev = params["mat_kd"].device
    stream = TileSampler(0, dev)(0, 0)
    true = {**params,
            "mat_kd": torch.tensor(TRUE_KD, device=dev),
            "mat_color": torch.tensor(TRUE_COLOR, device=dev)}
    with torch.no_grad():
        target = render_fn(true, stream)
    write_hdr(f"{a.out}_target.hdr", target.cpu().numpy())
    theta = {"mat_kd": torch.full((2,), 0.6, device=dev),
             "mat_color": torch.full((2, 3), 0.5, device=dev)}
    with torch.no_grad():
        write_hdr(f"{a.out}_init.hdr",
                  render_fn({**params, **theta}, stream).cpu().numpy())

    def log(i, loss):
        if i % 10 == 0 or i == a.steps - 1:
            print(f"step {i:3d}  loss {loss:.6f}")

    theta, _losses = recover(render_fn, params, target, stream, theta,
                             a.steps, log=log)
    with torch.no_grad():
        final = render_fn({**params, **theta}, stream)
    write_hdr(f"{a.out}_final.hdr", final.cpu().numpy())
    print("\nrecovered vs true:")
    print("  kd   ", theta["mat_kd"].cpu().numpy(), "vs", TRUE_KD)
    print("  color\n", theta["mat_color"].cpu().numpy(), "\nvs\n", TRUE_COLOR)
    print(f"wrote {a.out}_{{target,init,final}}.hdr")
    return 0


if __name__ == "__main__":
    sys.exit(main())
