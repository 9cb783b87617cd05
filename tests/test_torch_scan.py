"""The dense AO scan: above MAX_TRIS_FOR_MEGAKERNEL padded triangles on
the dense tiles, plain and sunsky AO scan the strata through the dense
any-hit, each stratum with its own jitter (lucille_tpu/transport/
ao.py:173-195 and :230-257); and the area lights' device tables, which
live and die with the Renderer's light tables.

The scans are held against lucille_tpu lane for lane on the bundled
scene (322 triangles in 512 padded slots) with both packages' threshold
patched down to 256 (lucille_tpu reads pallas_ao's at call time; the
port's transport/ao.py imported its own), the port fed lucille_tpu's
own draws by `JaxStream` / `JaxSampler` (test_torch_render.py), the JAX
any-hit in interpret mode.  The scan keeps every lane in raster order,
so a lane's jitter is the same on both sides and only f32 rounding
differs (XLA:CPU contracts the directions' products into FMAs):

- one wavefront of eye rays: hit masks equal; per lane the occluded
  strata within 1 on every lane both hit, equal on all but 1% of them;
  the sky radiance within 1e-4 of max(|value|, 1) on all but 1% of
  them;
- whole frames: test_torch_render.py's bounds for the bundled scene
  (mean |diff| <= 1e-3, <= 0.07 on pixels whose subsample hits agree)
  and test_torch_sunsky.py's for its sunsky frame.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxSampler, JaxStream, _eye_hits
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import bundled_state

THRESHOLD = 256  # below the bundled scene's 512 padded slots
NTHETA = NPHI = 4


@pytest.fixture
def low_threshold(monkeypatch):
    """Both packages' MAX_TRIS_FOR_MEGAKERNEL at THRESHOLD."""
    monkeypatch.setattr("lucille_tpu.accel.pallas_ao.MAX_TRIS_FOR_MEGAKERNEL",
                        THRESHOLD)
    monkeypatch.setattr(
        "lucille_tpu_torch.accel.gather.MAX_TRIS_FOR_MEGAKERNEL", THRESHOLD)


def _counts():
    from lucille_tpu_torch.accel import ao, isect

    counts = {"any_hit": isect.ANY_COUNTS, "ao": ao.COUNTS,
              "ao_bits": ao.BITS_COUNTS}
    for c in counts.values():
        c.reset()
    return counts


@pytest.mark.parametrize("sunsky", [False, True])
def test_scan_wavefront_matches_jax(sunsky, low_threshold):
    """ao_radiance of both packages on one 512-ray wavefront of the
    bundled scene's eye rays, the gather keyed by the same jax key."""
    from lucille_tpu.lights.tables import build_light_tables as jax_lights
    from lucille_tpu.scene.compile import compile_scene as jax_compile
    from lucille_tpu.transport.ao import ao_radiance as jax_ao
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.scene.compile import compile_scene
    from lucille_tpu_torch.accel.gather import gather_kind
    from lucille_tpu_torch.transport.ao import ao_radiance
    from test_torch_whitted import eye_rays

    B, S = 512, NTHETA * NPHI
    jdesc = bundled_state(16, 16, sunsky=sunsky, pkg="jax").scene
    desc = bundled_state(16, 16, sunsky=sunsky).scene
    jscene = jax_compile(jdesc).device_put()
    scene = compile_scene(desc, "cpu")
    assert scene.accel == "dense" and gather_kind(scene) == "scan"
    o, d = eye_rays(jdesc.camera, B, seed=3)
    key = jax.random.key(11)
    ref, jaux = jax_ao(jscene, jnp.asarray(o), jnp.asarray(d), key, NTHETA,
                       NPHI, lights=jax_lights(jdesc))
    counts = _counts()
    got, aux = ao_radiance(scene, torch.from_numpy(o), torch.from_numpy(d),
                           JaxStream(key), NTHETA, NPHI,
                           lights=build_light_tables(desc, device="cpu"))
    # the scan's S any-hit wavefronts (and a sun ray's), no fused gather
    assert counts["any_hit"].plain == S + sunsky
    assert counts["ao"].plain == counts["ao_bits"].plain == 0
    ref, got = np.asarray(ref), got.numpy()
    hit = aux["hit"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(jaux["hit"]))
    assert 0.2 < hit.mean() < 1.0
    assert int(aux["nrays"]) == int(jaux["nrays"])
    if sunsky:
        assert ref[hit].mean() > 100.0  # sky radiance
        off = np.abs(got - ref) > 1e-4 * np.maximum(np.abs(ref), 1.0)
        assert off.any(axis=1)[hit].mean() <= 0.01
        return
    # plain AO: radiance (S - occluded) / S times the vertex colour (1 here)
    occ_ref = S * (1.0 - ref[hit, 0])
    occ = S * (1.0 - got[hit, 0])
    assert 0.5 < occ_ref.mean() < S - 0.5  # both answers occur
    diff = np.abs(np.round(occ) - np.round(occ_ref))
    assert diff.max() <= 1 and (diff != 0).mean() <= 0.01


@pytest.mark.parametrize("sunsky", [False, True])
def test_scan_frame_matches_jax(sunsky, low_threshold):
    """Both Renderers on the bundled scene at 32x24, one sample, 16 AO
    rays, tile 16 (four 256-ray wavefronts), the port with JaxSampler."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    def state(pkg):
        return bundled_state(32, 24, pixelsamples=1, gather=NTHETA * NPHI,
                             sunsky=sunsky, pkg=pkg)

    jr = JaxRenderer(state("jax").scene, tile_size=16)
    ref = jr.render_frame()
    desc = state("torch").scene
    counts = _counts()
    pr = Renderer(desc, tile_size=16, device="cpu", sampler=JaxSampler())
    got = pr.render_frame()
    assert counts["any_hit"].plain > 0
    assert counts["ao"].plain == counts["ao_bits"].plain == 0
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(got - ref)
    if sunsky:
        assert ref.mean() > 100.0
        assert diff.mean() / ref.mean() <= 1e-4
        assert (diff > 1e-4 * np.maximum(np.abs(ref), 1.0)).mean() <= 0.01
        assert abs(pr.stats.nrays - jr.stats.nrays) <= 2 * 17
        return
    hit_p, hit_j, n_sub = _eye_hits(desc, jr.desc, 16, pr.scene, jr.scene)
    assert (hit_p != hit_j).mean() <= 1e-3
    assert pr.stats.nrays - jr.stats.nrays == NTHETA * NPHI * (
        int(hit_p.sum()) - int(hit_j.sum()))
    assert n_sub == 1
    from lucille_tpu_torch.render.tiles import tile_list

    agree = np.zeros(got.shape[:2], bool)
    for ti, (x0, y0, _i, _j) in enumerate(tile_list(32, 24, 16, "spiral")):
        a = (hit_p == hit_j)[ti * 256 : (ti + 1) * 256].reshape(16, 16)
        th, tw = min(16, 24 - y0), min(16, 32 - x0)
        agree[y0 : y0 + th, x0 : x0 + tw] = a[:th, :tw]
    assert diff.mean() <= 1e-3
    assert diff[agree].max() <= 0.07
    assert (got[..., 0] > 0).mean() > 0.2


def test_area_light_tables_die_with_the_renderer():
    """An area light's triangles and their device tables are held by the
    Renderer's light tables and nothing else: two Renderers built, used
    and dropped leave no area light alive (weakrefs to the host arrays and
    the device tables)."""
    from lucille_tpu_torch.render.renderer import Renderer
    from test_torch_whitted import state

    refs = []
    for _ in range(2):
        r = Renderer(state("materials", "torch", method="whitted").scene,
                     tile_size=16, device="cpu")
        assert np.isfinite(r.render_frame()).all()
        area = next(li for li in r.lights if li.type == "area")
        assert area.area[1].device == r.device
        refs += [weakref.ref(area.tris["v0"]), weakref.ref(area.area[1])]
        del r, area
    gc.collect()
    assert all(ref() is None for ref in refs)
