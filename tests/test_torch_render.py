"""The whole AO slice: the port's Renderer (plain torch twins on the CPU)
against lucille_tpu's Renderer on accel "pallas" or "bvh" (its Pallas
kernels in interpret mode), frame against frame.

The port draws its random numbers from a per-tile stream; `JaxSampler`
hands it streams whose draws are the JAX renderer's own: the tile's key
fold_in(fold_in(key, x0), y0), folded along each draw's path, so the AO
jitter is uniform(tile key, (2, B)) and the two frames differ only where
f32 rounding differs:

- eye-ray hit masks may differ on near-grazing rays: at most 0.1%;
- nrays then differs by exactly S per such ray;
- on the bundled scene (4 triangle tiles: hit-first lane order) a lane
  keeps its jitter, so pixels differ only by flipped strata: mean
  |diff| <= 1e-3, and <= 0.07 on pixels whose subsample hits all agree
  (one flipped stratum of 16 is 1/16 of a subsample, 1/64 of a 2x2 pixel);
- on the heightfield (20 tiles: Morton lane order) a 1-ulp change of a
  shading point can move a lane across a Morton cell and shift the
  jitter of every lane in between, so only the frame statistics hold:
  mean |diff| <= 2e-3, means over hit pixels within 0.005;
- on the heightfield's tile BVH (24 leaf tiles) the jitter belongs to
  the raster lane on both sides, so a lane keeps it whatever the Morton
  order does, and the bundled case's per-pixel bounds hold (16 strata at
  1 sample: one flipped stratum is 1/16 of a pixel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import REPO, bundled_state, heightfield_state


class JaxStream:
    """A port stream (sampling/jitter.py) answering with jax.random's
    draws below `key`: path (p1, p2, ...) is fold_in(fold_in(key, p1),
    p2) ..."""

    def __init__(self, key):
        self.key = key

    def _key(self, path):
        k = self.key
        for p in path:
            k = jax.random.fold_in(k, p)
        return k

    def uniform(self, path, shape):
        u = jax.random.uniform(self._key(path), tuple(shape), jnp.float32)
        return torch.from_numpy(np.array(u))

    def randint(self, path, shape, high):
        i = jax.random.randint(self._key(path), tuple(shape), 0, high)
        return torch.from_numpy(np.array(i)).long()


class JaxSampler:
    """The JAX renderer's per-tile keys, as a port sampler."""

    def __init__(self, key=None):
        self.key = jax.random.key(0) if key is None else key

    def __call__(self, x0, y0):
        return JaxStream(jax.random.fold_in(jax.random.fold_in(self.key, x0),
                                            y0))


def _eye_hits(desc, jax_desc, tile, port_scene, jax_scene):
    """Per-ray eye hit masks of both packages over every full tile, in
    tile-list order: (port (R,) bool, jax (R,) bool, S subsamples); each
    package's rays from its own camera."""
    from lucille_tpu.accel.pallas_bvh import pallas_bvh_closest_hit
    from lucille_tpu.accel.pallas_isect import pallas_closest_hit
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.render.tiles import tile_list
    from lucille_tpu_torch.ri.camera import generate_rays
    from lucille_tpu_torch.sampling.hammersley import subpixel_samples

    opt = desc.options
    xs, ys = (int(r) for r in opt.current_display().sampling_rates)
    jit = subpixel_samples(xs, ys)[0].astype(np.float32)
    port, ref = [], []
    for x0, y0, _i, _j in tile_list(opt.width, opt.height, tile,
                                     opt.bucket_order):
        px = (np.arange(tile, dtype=np.float32) + np.float32(x0))[None, :, None]
        py = (np.arange(tile, dtype=np.float32) + np.float32(y0))[:, None, None]
        shape = (tile, tile, len(jit))
        fx = np.broadcast_to(px + jit[:, 0], shape).reshape(-1)
        fy = np.broadcast_to(py + jit[:, 1], shape).reshape(-1)
        o, d = generate_rays(desc.camera, torch.from_numpy(fx.copy()),
                             torch.from_numpy(fy.copy()))
        port.append(closest_hit(port_scene, o, d)["hit"].numpy())
        oj, dj = jax_desc.camera.generate_rays(jnp.asarray(fx),
                                               jnp.asarray(fy))
        jax_hit = (pallas_bvh_closest_hit if jax_scene.accel == "pbvh"
                   else pallas_closest_hit)
        ref.append(np.asarray(jax_hit(jax_scene, oj, dj,
                                      interpret=True)["hit"]))
    return np.concatenate(port), np.concatenate(ref), len(jit)


def _render_pair(make_state, tile):
    """The same RIB through each package's front end and Renderer."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(make_state("jax").scene, tile_size=tile)
    ref = jr.render_frame()
    desc = make_state("torch").scene
    pr = Renderer(desc, tile_size=tile, device="cpu", sampler=JaxSampler())
    got = pr.render_frame()
    return desc, jr, ref, pr, got


# (state factory of a package, tile, the scene's triangle tiles)
CASES = {
    "bundled": (lambda pkg: bundled_state(48, 32, pixelsamples=2, gather=16,
                                          pkg=pkg), 16, 4),
    "heightfield35": (lambda pkg: heightfield_state(35, 32, 32, pixelsamples=1,
                                                    pkg=pkg), 16, 20),
    "heightfield35_bvh": (lambda pkg: heightfield_state(
        35, 32, 32, pixelsamples=1, gather=16, accel="bvh", pkg=pkg), 16, 24),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_matches_jax(case):
    make_state, tile, _n_tiles = CASES[case]
    check_frame_against_jax(case, *_render_pair(make_state, tile))


def check_frame_against_jax(case, desc, jr, ref, pr, got):
    """The bounds of the module docstring, for CASES[case]'s frame: the
    port's Renderer pr (its frame got, of description desc) against
    lucille_tpu's jr (its frame ref)."""
    _make_state, tile, n_tiles = CASES[case]
    assert pr.scene.n_pad // 128 == n_tiles
    assert got.shape == ref.shape and np.isfinite(got).all()

    hit_p, hit_j, S = _eye_hits(desc, jr.desc, tile, pr.scene, jr.scene)
    n_ao = int(np.sqrt(desc.options.gather_nsamples)) ** 2
    flips = hit_p != hit_j
    assert flips.mean() <= 1e-3, flips.sum()
    assert pr.stats.nrays - jr.stats.nrays == n_ao * (
        int(hit_p.sum()) - int(hit_j.sum()))

    diff = np.abs(got - ref)
    # pixels of the visible image whose subsample hits all agree / all hit
    H, W = got.shape[:2]
    from lucille_tpu_torch.render.tiles import tile_list

    agree = np.zeros((H, W), bool)
    allhit = np.zeros((H, W), bool)
    per_tile = tile * tile * S
    for ti, (x0, y0, _i, _j) in enumerate(
            tile_list(W, H, tile, desc.options.bucket_order)):
        sl = slice(ti * per_tile, (ti + 1) * per_tile)
        a = (~flips[sl]).reshape(tile, tile, S).all(axis=2)
        h = (hit_p[sl] & hit_j[sl]).reshape(tile, tile, S).all(axis=2)
        th, tw = min(tile, H - y0), min(tile, W - x0)
        agree[y0 : y0 + th, x0 : x0 + tw] = a[:th, :tw]
        allhit[y0 : y0 + th, x0 : x0 + tw] = h[:th, :tw]
    assert allhit.mean() > 0.2
    assert pr.scene.accel == ("pbvh" if case.endswith("_bvh") else "dense")
    if n_tiles < 8 or case.endswith("_bvh"):  # each lane keeps its jitter
        assert diff.mean() <= 1e-3
        assert diff[agree].max() <= 0.07
    else:
        assert diff.mean() <= 2e-3
        assert abs(got[allhit].mean() - ref[allhit].mean()) <= 0.005


def test_default_sampler_agrees_in_mean():
    """The port's own torch.Generator jitter: a different draw, the same
    estimator, so only the mean over hit pixels is held (within 0.01)."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    make_state = CASES["bundled"][0]
    ref = JaxRenderer(make_state("jax").scene, tile_size=16).render_frame()
    got = Renderer(make_state("torch").scene, tile_size=16, device="cpu",
                   seed=3).render_frame()
    lit = (ref[..., 0] > 0) & (got[..., 0] > 0)
    assert lit.mean() > 0.2
    assert abs(got[lit].mean() - ref[lit].mean()) <= 0.01


def test_crop_window_matches_full_frame():
    """Tiles stay on the full-frame grid and the jitter follows the tile
    origin, so cropped pixels equal the full render's; outside is black."""
    from lucille_tpu_torch.render.renderer import Renderer

    make_state = CASES["bundled"][0]
    full = Renderer(make_state("torch").scene, tile_size=16,
                    device="cpu").render_frame()
    s = make_state("torch")
    s.CropWindow(0.3, 0.7, 0.25, 0.8)
    crop = Renderer(s.scene, tile_size=16, device="cpu").render_frame()
    x0, x1 = int(np.ceil(48 * 0.3)), int(np.ceil(48 * 0.7))
    y0, y1 = int(np.ceil(32 * 0.25)), int(np.ceil(32 * 0.8))
    np.testing.assert_array_equal(crop[y0:y1, x0:x1], full[y0:y1, x0:x1])
    mask = np.ones(crop.shape[:2], bool)
    mask[y0:y1, x0:x1] = False
    assert np.all(crop[mask] == 0)


def test_tiles_reach_callbacks_in_spiral_order():
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.render.tiles import tile_list

    seen = []
    Renderer(bundled_state(48, 32, pixelsamples=1, gather=4).scene,
             tile_size=16, device="cpu").render_frame(
        tile_cb=lambda x0, y0, t: seen.append((x0, y0, t.shape)))
    want = [(x0, y0) for x0, y0, _i, _j in tile_list(48, 32, 16, "spiral")]
    assert [(x, y) for x, y, _ in seen] == want
    assert all(shape == (16, 16, 3) for _x, _y, shape in seen)


@pytest.mark.parametrize("what", ["sunsky", "texture", "method", "ibl",
                                  "sl-stage"])
def test_unported_features_raise(what, tmp_path):
    """Each feature once refused here, now built: method, the grid accel
    (refused until the uniform grid was ported; before it, the shader
    method, which renders: tests/test_torch_shaded.py), renders a frame
    through the grid; sl-stage, an atmosphere shader whose .sl is
    on the search path (compiled and bound to the Renderer);
    ibl, a dome light with an environment texture, and texture, an "ibl"
    light's texture (environment maps are ported,
    tests/test_torch_envmap.py; a map not found leaves the light its flat
    colour, as in lucille_tpu); sunsky, sunsky AO on the dense tiles above
    131,072 triangles (the 257^2-quad terrain has 132,098), refused until
    the port scanned the strata as lucille_tpu does there
    (tests/test_torch_scan.py holds the scan against lucille_tpu)."""
    from lucille_tpu_torch.accel.ao import MAX_TRIS_FOR_MEGAKERNEL
    from lucille_tpu_torch.render.renderer import Renderer
    from lucille_tpu_torch.ri.types import LightDesc
    from lucille_tpu_torch.accel.gather import gather_kind

    desc = bundled_state(16, 16).scene
    if what == "sunsky":
        desc = heightfield_state(258, sunsky=True).scene
        assert sum(g.ntriangles for g in desc.geoms) == 132098
        r = Renderer(desc, device="cpu")
        assert r.scene.accel == "dense" and gather_kind(r.scene) == "scan"
        assert r.scene.tri_v0.shape[0] > MAX_TRIS_FOR_MEGAKERNEL
        assert any(li.type == "sunsky" for li in r.lights)
        return
    if what in ("ibl", "texture"):
        kind, name = ("dome", "sky.hdr") if what == "ibl" else ("ibl",
                                                                 "probe.exr")
        desc.lights.append(LightDesc(type=kind, texture=name))
        light = Renderer(desc, device="cpu").lights.lights[-1]
        assert light.type == kind and light.env is None
        return
    if what == "sl-stage":
        (tmp_path / "myfog.sl").write_text("volume myfog() { }\n")
        desc.options.searchpaths = [str(tmp_path)]
        desc.geoms[0].attrs.atmosphere = "myfog"
        r = Renderer(desc, device="cpu")
        assert r.atmosphere.fn.shader_name == "myfog"
        return
    desc.options.accel_method = "grid"
    r = Renderer(desc, tile_size=16, device="cpu")
    assert r.scene.accel == "ugrid" and r.scene.grid_res > 1
    img = r.render_frame()
    assert img.shape == (16, 16, 3) and 0 < img.mean() < 1


def test_matches_lucille_golden_80x60():
    """The port against CPU-lucille's own AO frame of the same scene
    (tests/golden/ao_80x60_ref.hdr, 3x3 samples, 64 rays), with the
    bound tests/test_render.py holds lucille_tpu to: independent random
    streams, so mean |diff| < 0.01 and < 0.5% of pixels off by > 0.1."""
    from lucille_tpu.imageio.rgbe import read_hdr
    from lucille_tpu_torch.render.renderer import Renderer

    golden = read_hdr(REPO / "tests" / "golden" / "ao_80x60_ref.hdr")
    img = Renderer(bundled_state(80, 60, accel="auto").scene, tile_size=32,
                   device="cpu").render_frame()
    diff = np.abs(golden - img[::-1]).mean(axis=-1)  # hdr rows are flipped
    assert diff.mean() < 0.01
    assert (diff > 0.1).mean() < 0.005
