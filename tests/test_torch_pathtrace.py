"""The path tracer: the port against lucille_tpu on the same inputs, and
lucille_tpu's own path-tracer checks (tests/test_transport.py) run on the
port.

Inputs, streams and tolerances as in test_torch_whitted.py: on the
bundled scene and the materials scene the eye hit masks and the ray
counts hold exactly and radiance within 1e-4 of max(|value|, 1) on all
but 1% of the lanes; on the heightfield's tile BVH the hit masks hold
and the mean over hits within 0.005.  The furnace check holds the mean
of 8 streams at 1 within 0.08, the bound tests/test_transport.py holds
lucille_tpu to.
"""

import numpy as np
import pytest
import torch

from test_torch_render import JaxSampler
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401
from test_torch_whitted import (
    check_lane_for_lane,
    close_rel,
    run_wavefront,
    state,
)


@pytest.mark.parametrize("kind,max_depth", [("bundled", 3),
                                            ("materials", 5)])
def test_path_wavefront_matches_jax(kind, max_depth):
    """The bundled scene under the dome (no light to sample: escaped
    rays carry the estimate) and the materials scene, whose distant,
    point and area lights are picked one per lane, with Russian roulette
    from the fourth bounce."""
    got, gaux, want, waux = run_wavefront("pathtrace", kind, max_depth)
    check_lane_for_lane(got, gaux, want, waux)
    assert int(waux["nrays"]) > 512 + waux["hit"].sum()  # bounces traced


def test_path_wavefront_on_the_tile_bvh_matches_jax():
    got, gaux, want, waux = run_wavefront("pathtrace", "hf", 2)
    np.testing.assert_array_equal(gaux["hit"], waux["hit"])
    hit = waux["hit"]
    assert hit.mean() > 0.3
    assert abs(int(gaux["nrays"]) - int(waux["nrays"])) <= 0.01 * int(
        waux["nrays"])
    assert abs(got[hit].mean() - want[hit].mean()) <= 0.005


def test_path_frame_matches_jax():
    """A 16x16 Renderer frame of the bundled scene: lucille_tpu's
    Renderer passes Option "trace" "max_ray_depth" (8), not
    path_radiance's default 10, and so does the port's."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(state("bundled", "jax", method="pathtrace").scene,
                     tile_size=16)
    ref = jr.render_frame()
    r = Renderer(state("bundled", "torch", method="pathtrace").scene,
                 tile_size=16, device="cpu", sampler=JaxSampler())
    got = r.render_frame()
    assert r.stats.nrays == jr.stats.nrays
    assert 0.5 < ref.mean() <= 1.0
    assert close_rel(got.reshape(-1, 3), ref.reshape(-1, 3), 1e-4).mean() \
        >= 0.99


# -- lucille_tpu's path-tracer checks (tests/test_transport.py) -------------

def _plane_scene(extra_rib="", lights_rib=""):
    """lucille_tpu's test plane (50 x 50, facing +y) through the port."""
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.scene.compile import compile_scene

    s = RiState()
    parse_rib(
        "WorldBegin\n" + lights_rib
        + 'PointsPolygons [4] [0 3 2 1] "P" [-50 0 -50  50 0 -50  50 0 50  '
        "-50 0 50]\n" + extra_rib + "WorldEnd\n", s)
    return compile_scene(s.scene, "cpu"), build_light_tables(s.scene,
                                                             device="cpu")


def _down_rays(B=64, height=5.0):
    x = torch.linspace(-3, 3, B)
    org = torch.stack([x, torch.full((B,), height), x], dim=-1)
    return org, torch.tensor([0.0, -1.0, 0.0]).expand(B, 3).contiguous()


def _key(seed):
    from lucille_tpu_torch.sampling.jitter import StreamKey, TileSampler

    return StreamKey(TileSampler(seed, "cpu")(0, 0))


def test_furnace_closed_environment():
    """A white lambertian plane under a unit dome: the surface radiance
    converges to the dome's (tests/test_transport.py:48)."""
    from lucille_tpu_torch.transport.pathtrace import path_radiance

    scene, lights = _plane_scene(
        lights_rib='LightSource "domelight" 1 "intensity" [1.0]\n')
    org, dirn = _down_rays(256)
    out = [path_radiance(scene, lights, org, dirn, _key(i), max_depth=6)[0]
           for i in range(8)]
    assert float(torch.cat(out).mean()) == pytest.approx(1.0, abs=0.08)


def test_black_without_lights_or_background():
    from lucille_tpu_torch.lights.tables import LightTables
    from lucille_tpu_torch.transport.pathtrace import path_radiance

    scene, _ = _plane_scene()
    org, dirn = _down_rays(32)
    r, _ = path_radiance(scene, LightTables([]), org, dirn, _key(0))
    assert torch.all(r.abs() <= 1e-6)


def test_escaped_rays_see_background():
    from lucille_tpu_torch.lights.tables import LightTables
    from lucille_tpu_torch.transport.pathtrace import path_radiance

    scene, _ = _plane_scene()
    org = torch.tensor([0.0, 1.0, 0.0]).expand(16, 3).contiguous()
    dirn = torch.tensor([0.0, 1.0, 0.0]).expand(16, 3).contiguous()
    r, aux = path_radiance(scene, LightTables([]), org, dirn, _key(0),
                           bgcolor=(0.25, 0.5, 0.75))
    torch.testing.assert_close(
        r, torch.tensor([0.25, 0.5, 0.75]).expand(16, 3), rtol=0, atol=1e-6)
    assert int(aux["nrays"]) == 16  # nothing hit: no bounce, no NEE ray


def test_area_light_illuminates():
    from lucille_tpu_torch.transport.pathtrace import path_radiance

    scene, lights = _plane_scene(extra_rib=(
        "AttributeBegin\n"
        'AreaLightSource "arealight" 2 "intensity" [5.0]\n'
        'PointsPolygons [4] [0 1 2 3] "P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]\n'
        "AttributeEnd\n"))
    assert lights.nlights == 1 and lights.lights[0].tris is not None
    org, dirn = _down_rays(128, height=2.0)
    r, _ = path_radiance(scene, lights, org, dirn, _key(0))
    assert float(r.mean()) > 0.01
