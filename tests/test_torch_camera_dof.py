"""Thin-lens depth of field (ri/camera.generate_rays with lens samples)
against lucille_tpu's Camera.generate_rays, and a depth-of-field frame
of both Renderers.

Tolerances: rays within 1e-6 absolute (the same f32 constants and
operation order; XLA:CPU may contract a product and a sum into an FMA,
one rounding, and may round cos/sin by an ulp).  The frame is the
bundled scene at 32x24, one sample, 16 AO rays, tile 16: four tiles,
below the 8 at which lucille_tpu's Morton lane order would amplify an
ulp into moved jitter (ROADMAP Queue 3), each tile's lens samples drawn
from the same stream path (0x10EF,) on both sides (`JaxSampler`).  So
test_torch_render.py's bundled bounds hold: eye hits differ on at most
0.1% of the rays (nrays within 16 x 0.1% of 768), mean |diff| <= 1e-3,
and at most 0.1% of the pixels off by more than 0.07 (one flipped
stratum of 16 at one sample is 1/16; a flipped eye hit more).
"""

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_render import JaxSampler
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import bundled_rib_text, front_end

# f-stop 2, focal length 1 (a lens of radius 0.25), focused at 15.5: the
# camera sits 15.53 from the scene's centre, so the focal plane crosses it
DOF_LINE = "DepthOfField 2.0 1.0 15.5\n"


def dof_state(pkg, width=32, height=24, pixelsamples=1, gather=16):
    """The bundled scene without its sunsky line, under DOF_LINE."""
    RiState, parse_rib = front_end(pkg)
    text = bundled_rib_text().replace("WorldBegin", DOF_LINE + "WorldBegin",
                                      1)
    s = RiState()
    parse_rib(text, s)
    s.Format(width, height)
    s.PixelSamples(pixelsamples, pixelsamples)
    s.options.gather_nsamples = gather
    s.options.accel_method = "pallas"
    return s


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 32, n).astype(np.float32)
    py = rng.uniform(0, 24, n).astype(np.float32)
    lens = rng.uniform(size=(n, 2)).astype(np.float32)
    return px, py, lens


def test_lens_rays_match_jax():
    from lucille_tpu_torch.ri.camera import generate_rays

    cam, ref_cam = dof_state("torch").camera, dof_state("jax").camera
    assert cam.dof_active and ref_cam.dof_active
    px, py, lens = _rays(999, 3)
    o_ref, d_ref = ref_cam.generate_rays(jnp.asarray(px), jnp.asarray(py),
                                         jnp.asarray(lens))
    o, d = generate_rays(cam, torch.from_numpy(px), torch.from_numpy(py),
                         torch.from_numpy(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=1e-6)
    # the origins spread over the lens disk, of radius f / (2 fstop)
    c2w = cam.camera_to_world
    r = np.linalg.norm(o.numpy() - c2w[3, :3], axis=-1)
    assert r.max() <= 0.25 + 1e-5 and r.max() > 0.2


def test_pinhole_limit_equals_the_rays_without_dof():
    """A lens sample at the disk's centre gives the pinhole ray: the
    camera's position, through the same raster point."""
    from lucille_tpu_torch.ri.camera import generate_rays

    cam = dof_state("torch").camera
    px, py, _lens = _rays(999, 4)
    px, py = torch.from_numpy(px), torch.from_numpy(py)
    o, d = generate_rays(cam, px, py, torch.zeros((999, 2)))
    cam.fstop = float("inf")
    assert not cam.dof_active
    o0, d0 = generate_rays(cam, px, py)
    np.testing.assert_allclose(o.numpy(), o0.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), d0.numpy(), rtol=0, atol=1e-6)


def test_dof_frame_matches_jax():
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list

    jr = JaxRenderer(dof_state("jax").scene, tile_size=16)
    ref = jr.render_frame()
    pr = Renderer(dof_state("torch").scene, tile_size=16, device="cpu",
                  sampler=JaxSampler())
    got = pr.render_frame()
    assert len(tile_list(32, 24, 16, "spiral")) == 4
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert (got[..., 0] > 0).mean() > 0.2
    assert abs(pr.stats.nrays - jr.stats.nrays) <= 16 * 768 * 1e-3
    diff = np.abs(got - ref)
    assert diff.mean() <= 1e-3
    assert (diff.max(axis=-1) > 0.07).mean() <= 1e-3
    # the lens moved the rays: the frame differs from the pinhole one
    cam = pr.camera
    cam.fstop = float("inf")
    pin = Renderer(pr.desc, tile_size=16, device="cpu",
                   sampler=JaxSampler()).render_frame()
    assert np.abs(pin - got).mean() > 1e-3
