"""Differentiable rendering (lucille_tpu_torch.diff) against lucille_tpu's
diff module, at tests/test_diff.py's settings: its scene (a ground quad
and a coloured triangle under the constant dome), 24x16, 2 samples,
depth 3, path traced.

lucille_tpu compiles that scene on the CPU with its "mxu" accel (its
"auto" picks the MXU path on a CPU backend); the port is given the same
request ("mxu": its dense kernels' twins, triangles in input order).
Both packages draw from lucille_tpu's keys (`JaxStream`), so:

- the images agree within 1e-5;
- every parameter's gradient of the mean image (mat_kd, mat_ks,
  mat_color, mat_emission, light_color, light_intensity) agrees with
  jax.grad's within 1e-4 relative (1e-7 absolute): the same estimator,
  differentiated through the same torch / XLA glue;
- kd's and the dome's intensity gradients agree with central finite
  differences of the port's own image within 2e-3, test_diff.py's bound
  (common random numbers);
- the light's colour and intensity gradients are non-zero: a parameter
  tensor passes through device.const_vec instead of being read as
  numbers;
- a 16x12 frame recovers kd in 40 Adam steps (the inverse-render
  example's `recover`): the loss falls tenfold and kd lands within 0.05
  of the truth, test_diff.py's bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxStream
from test_torch_scene import one_torch_thread  # noqa: F401

PARAMS = ("mat_kd", "mat_ks", "mat_color", "mat_emission", "light_color",
          "light_intensity")


def _jax_setup(width=24, height=16):
    from lucille_tpu.diff.render import differentiable_render
    from lucille_tpu.lights.tables import build_light_tables
    from lucille_tpu.render.renderer import _FrozenCamera
    from lucille_tpu.ri.api import RiState
    from lucille_tpu.rib.parser import parse_rib
    from lucille_tpu.scene.compile import compile_scene
    from lucille_tpu_torch.examples.inverse_render import SCENE_RIB

    s = RiState()
    parse_rib(SCENE_RIB, s)
    s.Format(width, height)
    s.camera.setup(s.world_to_camera, s.options.orientation)
    scene = compile_scene(s.scene).device_put()
    assert scene.accel == "mxu"
    return differentiable_render(scene, build_light_tables(s.scene),
                                 _FrozenCamera.from_camera(s.camera), width,
                                 height, spp=2, max_depth=3)


def _port_setup(width=24, height=16):
    from lucille_tpu_torch.examples.inverse_render import setup

    return setup(width, height, "cpu", spp=2, max_depth=3, accel="mxu")


def _grad(render_fn, params, name, stream):
    leaf = params[name].detach().clone().requires_grad_(True)
    loss = torch.mean(render_fn({**params, name: leaf}, stream))
    (g,) = torch.autograd.grad(loss, [leaf])
    return g


def test_image_and_gradients_match_jax():
    jf, jp = _jax_setup()
    pf, pp = _port_setup()
    key = jax.random.key(7)
    assert set(pp) == set(jp) == set(PARAMS)
    for k in PARAMS:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
    ref = np.asarray(jf(jp, key))
    got = pf(pp, JaxStream(key))
    assert got.shape == (16, 24, 3) and 0.5 < ref.mean() < 1.5
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)

    want = jax.grad(lambda p: jnp.mean(jf(p, key)))(jp)
    for k in PARAMS:
        g = _grad(pf, pp, k, JaxStream(key))
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_loss_and_grad_match_jax():
    """render_loss_and_grad against lucille_tpu's, on a perturbed target:
    the loss and every gradient in one backward pass."""
    from lucille_tpu.diff.render import render_loss_and_grad as jax_lg
    from lucille_tpu_torch.diff import render_loss_and_grad

    jf, jp = _jax_setup()
    pf, pp = _port_setup()
    key = jax.random.key(5)
    target = np.asarray(jf(dict(jp, mat_kd=jnp.asarray([0.4, 0.8])), key))
    loss_j, g_j = jax_lg(jf, jnp.asarray(target), jp, key)
    loss, g = render_loss_and_grad(pf, torch.tensor(target), pp,
                                   JaxStream(key))
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-4)
    assert float(loss) > 0
    for k in PARAMS:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(g_j[k]),
                                   rtol=1e-4, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("name", ["mat_kd", "light_intensity"])
def test_gradient_matches_finite_differences(name):
    pf, pp = _port_setup()
    key = jax.random.key(9)
    g = _grad(pf, pp, name, JaxStream(key))
    eps = 1e-2
    with torch.no_grad():
        for i in range(pp[name].shape[0]):
            e = torch.zeros_like(pp[name])
            e[i] = eps
            hi = pf({**pp, name: pp[name] + e}, JaxStream(key)).mean()
            lo = pf({**pp, name: pp[name] - e}, JaxStream(key)).mean()
            fd = float(hi - lo) / (2 * eps)
            assert float(g[i]) == pytest.approx(fd, abs=2e-3), (name, i)
    assert float(g.sum()) > 0.0


def test_light_gradients_reach_the_parameters():
    """The dome's colour and intensity reach the image through
    device.const_vec (the escaped rays' background): their gradients are
    non-zero and positive, and the material colour's too."""
    pf, pp = _port_setup()
    key = jax.random.key(10)
    for name in ("light_color", "light_intensity", "mat_color"):
        g = _grad(pf, pp, name, JaxStream(key))
        assert torch.isfinite(g).all() and float(g.sum()) > 0.0, name
        if name.startswith("light"):
            assert torch.all(g != 0), name


def test_recovers_material_kd():
    from lucille_tpu_torch.examples.inverse_render import recover

    pf, pp = _port_setup(16, 12)
    stream = JaxStream(jax.random.key(11))
    kd_true = torch.tensor([0.3, 0.85])
    with torch.no_grad():
        target = pf({**pp, "mat_kd": kd_true}, stream)
    theta, losses = recover(pf, pp, target, stream,
                            {"mat_kd": torch.tensor([0.6, 0.5])}, steps=40)
    assert losses[-1] < 0.1 * losses[0]
    np.testing.assert_allclose(theta["mat_kd"].numpy(), kd_true.numpy(),
                               atol=0.05)
