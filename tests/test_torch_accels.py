"""lucille_tpu's "bruteforce" and "mxu" requests on the port's dense tiles,
and the re-binned tile-BVH gather (LUCILLE_BVH_AO=rebinned), against
lucille_tpu.

- The compile under either request keeps the triangles in input order,
  as lucille_tpu's does (it Morton-sorts for "pallas" alone): every
  array equal, bit for bit, so triangle ids compare.
- 80x60 AO and Whitted (depth 2) frames of the bundled scene, both
  packages fed lucille_tpu's draws (`JaxSampler`): lucille_tpu traces
  with its brute-force or MXU intersector and scans the AO strata through
  its any-hit, the port traces with its dense kernels' twins and scans
  the same strata; Whitted's dome is gathered by cosine-weighted shadow
  rays on both.  The MXU path forms t from triple products, so t differs
  by rounding: pixels within 1e-4 on all but 1% of the pixels, the ray
  counts equal.
- The re-binned gather on the 35x35 heightfield's tile BVH (32x32, 16
  gather rays) against lucille_tpu's re-binned path: test_torch_render's
  bound for the tile BVH's frames (mean |difference| <= 1e-3; a pixel
  whose eye hits agree within 0.07, one stratum of 16 flipping at a
  near-tie of the two BVH any-hits); the port's re-binned frame equals
  its cone-tiled frame exactly (the same rays, in another order).
"""

import numpy as np
import pytest
import torch

from test_torch_render import JaxSampler
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import bundled_state, heightfield_state


@pytest.mark.parametrize("accel", ["bruteforce", "mxu"])
def test_dense_requests_keep_input_order(accel):
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu_torch.scene.compile import compile_arrays
    from lucille_tpu_torch.scene.types import ARRAY_FIELDS, from_numpy

    ref = jax_compile(bundled_state(accel=accel, pkg="jax").scene)
    got = compile_arrays(bundled_state(accel=accel).scene)
    sorted_ = compile_arrays(bundled_state(accel="pallas").scene)
    assert ref.accel == got.intersector == accel and got.accel == "dense"
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert not np.array_equal(got.tri_v0, sorted_.tri_v0)
    scene = from_numpy(ref, "cpu")  # lucille_tpu's arrays carry over
    assert (scene.accel, scene.intersector) == ("dense", accel)


@pytest.mark.parametrize("accel,method", [
    ("bruteforce", "ao"), ("bruteforce", "whitted"), ("mxu", "ao"),
    ("mxu", "whitted")])
def test_dense_request_frame_matches_jax(accel, method):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.accel import ao, isect
    from lucille_tpu_torch.render.renderer import Renderer

    def make(pkg):
        s = bundled_state(80, 60, pixelsamples=1, gather=16, accel=accel,
                          pkg=pkg)
        s.options.render_method = method
        s.options.max_ray_depth = 2
        return s

    jr = JaxRenderer(make("jax").scene, tile_size=40)
    ref = jr.render_frame()
    for c in (ao.COUNTS, isect.COUNTS, isect.ANY_COUNTS):
        c.reset()
    r = Renderer(make("torch").scene, tile_size=40, device="cpu",
                 sampler=JaxSampler())
    got = r.render_frame()
    assert jr.scene.accel == accel and r.scene.intersector == accel
    assert r.stats.nrays == jr.stats.nrays
    off = np.abs(got - ref) > 1e-4 * np.maximum(np.abs(ref), 1.0)
    assert off.mean() <= 0.01
    assert 0.1 < ref.mean() < 1.0
    # no fused gather: the strata (AO) or the dome's shadow rays (Whitted)
    # went through the dense any-hit, as lucille_tpu's do
    assert ao.COUNTS.plain == 0
    want = {"ao": 4 * 16, "whitted": 4 * 2 * 4}[method]
    assert isect.ANY_COUNTS.plain == want


def test_rebinned_frame_matches_jax(monkeypatch):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.accel import bvh_isect
    from lucille_tpu_torch.render.renderer import Renderer

    def make(pkg):
        return heightfield_state(35, 32, 32, pixelsamples=1, gather=16,
                                 accel="bvh", pkg=pkg)

    monkeypatch.setenv("LUCILLE_BVH_AO", "rebinned")
    jr = JaxRenderer(make("jax").scene, tile_size=16)
    ref = jr.render_frame()
    bvh_isect.ANY_COUNTS.reset()
    r = Renderer(make("torch").scene, tile_size=16, device="cpu",
                 sampler=JaxSampler())
    got = r.render_frame()
    assert r.scene.accel == "pbvh"
    assert bvh_isect.ANY_COUNTS.plain == 4  # one sorted wavefront a tile
    assert r.stats.nrays == jr.stats.nrays
    diff = np.abs(got - ref)
    assert diff.mean() <= 1e-3 and diff.max() <= 0.07
    assert 0.1 < ref.mean() < 1.0

    monkeypatch.setenv("LUCILLE_BVH_AO", "cone")
    cone = Renderer(make("torch").scene, tile_size=16, device="cpu",
                    sampler=JaxSampler()).render_frame()
    np.testing.assert_array_equal(cone, got)


def test_rebinned_gather_sorts_its_rays(monkeypatch):
    """The re-binned gather traces its S x B rays in key order: the
    direction octant first, and the parked (dead) rays last."""
    from lucille_tpu_torch.accel import bvh_ao
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.ops.frame import ortho_basis

    scene = compile_scene(heightfield_state(35, accel="bvh").scene, "cpu")
    rng = np.random.default_rng(3)
    B = 64
    n = rng.normal(size=(B, 3)).astype(np.float32)
    n[:, 1] = np.abs(n[:, 1]) + 0.5
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    P = torch.from_numpy(rng.uniform(-4, 4, (B, 3)).astype(np.float32))
    P[:, 1] = 1.0
    b0, b1, b2 = ortho_basis(torch.from_numpy(n))
    hit = torch.from_numpy(rng.uniform(size=B) < 0.75)
    jitter = torch.from_numpy(rng.uniform(size=(2, B)).astype(np.float32))
    seen = []

    def spy(sc, o, d, *a, **k):
        seen.append((o.clone(), d.clone()))
        return {"occ": torch.zeros(o.shape[0], dtype=torch.bool)}

    monkeypatch.setattr(bvh_ao, "any_hit", spy)
    occ = bvh_ao.bvh_ao_rebinned(scene, P, b0, b1, b2, hit, jitter, 2, 2)
    (o, d), = seen
    assert occ.shape == (B,) and not occ.any()
    n_live = 4 * int(hit.sum())
    far = scene.bbox_min - (scene.bbox_max - scene.bbox_min) - 1.0
    assert torch.equal(o[n_live:], far.expand(4 * B - n_live, 3))
    octant = ((d[:n_live, 0] > 0).int() * 4 + (d[:n_live, 1] > 0).int() * 2
              + (d[:n_live, 2] > 0).int())
    assert torch.all(octant[1:] >= octant[:-1])
