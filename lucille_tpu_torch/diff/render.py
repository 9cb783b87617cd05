"""Differentiable forward rendering and the loss / gradient helper.

Counterpart of lucille_tpu/diff/render.py on torch autograd:
`differentiable_render` exposes the frame as a function of a parameter
dict (material kd / ks / colour / emission, light colour and intensity),
and `render_loss_and_grad` takes the gradients of an L2 pixel loss in one
backward pass, where lucille_tpu calls `jax.value_and_grad`.

- The frame is one wavefront of width x height eye rays a sample, as in
  lucille_tpu: per sample s, raster positions jittered by the draws at
  the paths (s, 0) and (s, 1) of the stream, the integrator called with
  the stream below (s,), as lucille_tpu folds its key
  (fold_in(fold_in(key, s), 0), ...).  `render_fn(params, stream)` takes
  a stream (sampling/jitter.py) where lucille_tpu's takes a key; the
  same stream gives the same draws, so finite differences and autograd
  see one estimator (common random numbers).
- Parameters enter as tensors: the scene's material rows are replaced
  (`scene_with_params`), and the light tables get the parameter tensors
  as their colour and intensity (`lights_with_params`), which the
  integrators read through `device.const_vec` (a tensor passes through
  it unchanged, so its gradient is kept).
- Visibility is detached: the kernels' inputs (rays, the scene's
  triangles) never depend on a parameter.
"""

from __future__ import annotations

import dataclasses

import torch

from lucille_tpu_torch.lights.tables import LightTables
from lucille_tpu_torch.ri.camera import generate_rays

PARAM_NAMES = ("mat_kd", "mat_ks", "mat_color", "mat_emission",
               "light_color", "light_intensity")


def scene_with_params(scene, params: dict):
    """The SceneTensors with any of mat_kd (G,), mat_ks (G,), mat_color
    (G, 3) and mat_emission (G, 3) replaced by params' tensors; everything
    else carried over."""
    updates = {k: v for k, v in params.items() if hasattr(scene, k)}
    return dataclasses.replace(scene, **updates)


def lights_with_params(lights, params: dict):
    """LightTables whose lights take their colour from params
    "light_color" (L, 3) and their intensity from "light_intensity"
    (L,), as tensors; the light tables themselves unchanged without
    either."""
    lc = params.get("light_color")
    li = params.get("light_intensity")
    if lc is None and li is None:
        return lights
    new = []
    for i, light in enumerate(lights):
        kw = {}
        if lc is not None:
            kw["color"] = lc[i]
        if li is not None:
            kw["intensity"] = li[i]
        new.append(dataclasses.replace(light, **kw))
    return LightTables(new)


class _Below:
    """The stream below the path `prefix`: what a folded key is to
    lucille_tpu (stream.uniform(prefix + path, shape))."""

    def __init__(self, stream, prefix: tuple):
        self.stream = stream
        self.prefix = prefix

    def uniform(self, path, shape):
        return self.stream.uniform(self.prefix + tuple(path), shape)

    def randint(self, path, shape, high: int):
        return self.stream.randint(self.prefix + tuple(path), shape, high)


def differentiable_render(scene, lights, camera, width: int, height: int,
                          method: str = "pathtrace", spp: int = 4,
                          max_depth: int = 4):
    """Build image = render_fn(params, stream), (height, width, 3) f32 on
    the scene's device, with the stream's draws on that device.  Returns
    (render_fn, param_template): the template holds every parameter's
    current value (the scene's material rows, the lights' colours and
    intensities) on the scene's device."""
    from lucille_tpu_torch.transport.dispatch import get_integrator

    integrator = get_integrator(method)
    dev = scene.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij")
    param_template = {
        "mat_kd": scene.mat_kd,
        "mat_ks": scene.mat_ks,
        "mat_color": scene.mat_color,
        "mat_emission": scene.mat_emission,
        "light_color": torch.tensor([list(li.color) for li in lights],
                                    dtype=torch.float32, device=dev),
        "light_intensity": torch.tensor([li.intensity for li in lights],
                                        dtype=torch.float32, device=dev),
    }

    def render_fn(params: dict, stream) -> torch.Tensor:
        sc = scene_with_params(scene, params)
        lt = lights_with_params(lights, params)
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=dev)
        for s in range(spp):
            ks = _Below(stream, (s,))
            ux = ks.uniform((0,), xs.shape)
            uy = ks.uniform((1,), ys.shape)
            org, dirn = generate_rays(camera, (xs + ux).reshape(-1),
                                      (ys + uy).reshape(-1))
            radiance, _aux = integrator(sc, lt, org, dirn, ks,
                                        max_depth=max_depth)
            acc = acc + radiance.reshape(height, width, 3)
        return acc / spp

    return render_fn, param_template


def render_loss_and_grad(render_fn, target: torch.Tensor, params: dict,
                         stream):
    """(L2 pixel loss () f32, {name: gradient}) for params, one backward
    pass; a parameter the frame does not reach gets a zero gradient."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    img = render_fn(leaves, stream)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}
