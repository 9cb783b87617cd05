"""Differentiable rendering on torch autograd.

Counterpart of lucille_tpu/diff: pixel losses differentiate end to end to
the material and light parameters (mat_kd, mat_ks, mat_color,
mat_emission, light_color, light_intensity) through the torch glue of the
integrators.  Visibility (hit masks, traversal) is piecewise constant and
carries no gradient, as in lucille_tpu: no parameter reaches a kernel's
inputs, so no CUDA kernel needs a backward pass.
"""

from lucille_tpu_torch.diff.render import (
    differentiable_render,
    lights_with_params,
    render_loss_and_grad,
    scene_with_params,
)

__all__ = [
    "differentiable_render",
    "lights_with_params",
    "scene_with_params",
    "render_loss_and_grad",
]
