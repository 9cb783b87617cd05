"""Image-based lighting: the five samplers (lights/ibl.py),
`light_wi_cl` and the integrators under an environment map, the port
against lucille_tpu on the same inputs, lane for lane.

The port's random numbers come from `test_torch_render.JaxStream`, whose
draws are lucille_tpu's own for the same fold-in chains (fold(i + 1000)
per light inside direct_diffuse, then fold(si) per sample, fold(i *
nphi + j) per stratum, fold(7000 + index) in light_wi_cl).  The map is
`test_torch_whitted.ibl_map_dir`'s (10x5 lat-long, 50 texels: bruteforce
traces 50 shadow wavefronts; its 24x24 angular resampling); wavefronts
are 512 lanes.  lucille_tpu's Pallas kernels run in interpret mode.

Tolerances (test_torch_whitted.py's): per lane within 1e-5 of max(|v|,
1) on all but 1% of the lanes (a shadow ray grazing an edge can flip
under XLA's FMA contraction) for the samplers and light_wi_cl; the
integrators' eye hit masks and ray counts exactly, radiance within 1e-4
of max(|v|, 1) on all but 1% of the lanes / pixels and the means within
1e-3 of max(mean, 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxSampler, JaxStream
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import front_end
from test_torch_whitted import (
    IBL_SAMPLERS,
    LIGHT_CASES,
    _eye_hits,
    check_lane_for_lane,
    close_rel,
    ibl_line,
    run_wavefront,
    t,
)


def _hf_ibl(pkg, sampler, width=None, height=None):
    """bench_large's terrain at n = 35 on the tile BVH under the IBL
    light of `ibl_line`."""
    from chip_smoke import heightfield_state

    s = heightfield_state(35, accel="bvh", api=front_end(pkg),
                          light=ibl_line(f"ibl-{sampler}"))
    if width is not None:
        s.Format(width, height)
        s.PixelSamples(1, 1)
    return s


def _shading_points(kind, B=512):
    """Both packages' (scene, lights), and P, N, the hit mask of B eye
    rays (kind "hf-<sampler>": the tile-BVH terrain; else a
    test_torch_whitted kind)."""
    from lucille_tpu_torch.accel.dispatch import closest_hit
    from lucille_tpu_torch.transport.common import face_forward, interp_hit

    if not kind.startswith("hf-"):
        (sj, lj), (st, lt), o, d, res = _eye_hits(kind, B, seed=1)
    else:
        from lucille_tpu.lights.tables import build_light_tables as jl
        from lucille_tpu.scene.compile import compile_scene as jc
        from lucille_tpu_torch.lights.tables import build_light_tables
        from lucille_tpu_torch.scene.compile import compile_scene
        from test_torch_whitted import eye_rays

        sampler = kind[3:]
        js, ts = _hf_ibl("jax", sampler), _hf_ibl("torch", sampler)
        sj, lj = jc(js.scene).device_put(), jl(js.scene)
        st, lt = compile_scene(ts.scene, "cpu"), build_light_tables(ts.scene, device="cpu")
        assert st.accel == "pbvh"
        o, d = eye_rays(js.scene.camera, B, 1, (160, 120))
        res = closest_hit(st, t(o), t(d))
    h = interp_hit(st, res, t(o), t(d))
    return (sj, lj), (st, lt), h["P"], face_forward(h["Ns"], t(d)), \
        res["hit"]


def _sampler_call(pkg, sampler, scene, light, P, N, key, active=None):
    """lights/ibl.py's sampler of `light` as _env_contribution calls it
    (nsamples 4; stratified 2 x 2), in package pkg."""
    if pkg == "jax":
        from lucille_tpu.lights import ibl
        env_table = light.env.importance_table if sampler in (
            "importance", "bruteforce") else None
        sis = light.env.sis_samples(64)
        kw = {}
    else:
        from lucille_tpu_torch.lights import ibl
        env_table = light.env.importance_table
        sis = light.env.structured
        kw = {"active": active}
    if sampler == "importance":
        return ibl.sample_env_importance(env_table, scene, P, N, key, 4, **kw)
    if sampler == "stratified":
        return ibl.sample_env_stratified(light.env.fetch, scene, P, N, key,
                                         2, 2, **kw)
    if sampler == "structured":
        return ibl.sample_env_structured(*sis, scene, P, N, **kw)
    if sampler == "bruteforce":
        return ibl.sample_env_bruteforce(env_table, scene, P, N, **kw)
    return ibl.sample_env_cosweight(light.env.fetch, scene, P, N, key, 4,
                                    **kw)


@pytest.mark.parametrize("sampler", IBL_SAMPLERS)
def test_samplers_on_the_tile_bvh_match_jax(sampler):
    """Each sampler on the terrain's tile BVH (kernel 5's twin), lane for
    lane; with the hit mask as `active` every live lane's answer is the
    one without it."""
    from lucille_tpu_torch.sampling.jitter import StreamKey

    (sj, lj), (st, lt), P, N, hit = _shading_points(f"hf-{sampler}")
    key = jax.random.fold_in(jax.random.key(9), 1000)
    got = _sampler_call("torch", sampler, st, lt.lights[0], P, N,
                        StreamKey(JaxStream(key)))
    live = _sampler_call("torch", sampler, st, lt.lights[0], P, N,
                         StreamKey(JaxStream(key)), active=hit)
    want = _sampler_call("jax", sampler, sj, lj.lights[0],
                         jnp.asarray(P.numpy()), jnp.asarray(N.numpy()), key)
    got, live, want, hit = (got.numpy(), live.numpy(), np.asarray(want),
                            hit.numpy())
    assert got.shape == (512, 3) and 0.3 < hit.mean() < 1.0
    np.testing.assert_array_equal(live[hit], got[hit])
    assert close_rel(got[hit], want[hit], 1e-5).mean() >= 0.99
    assert want[hit].std(axis=0).min() > 1e-3  # light varies over lanes


def test_bruteforce_strides_to_its_texel_budget():
    """Above max_texels the bruteforce sampler takes every stride-th
    texel with stride x the solid angle, as lucille_tpu's."""
    from lucille_tpu.lights import ibl as jibl
    from lucille_tpu_torch.lights import ibl

    (sj, lj), (st, lt), P, N, hit = _shading_points("ibl-bruteforce", 256)
    got = ibl.sample_env_bruteforce(lt.lights[0].env.importance_table, st, P,
                                    N, max_texels=12).numpy()
    want = np.asarray(jibl.sample_env_bruteforce(
        lj.lights[0].env.importance_table, sj, jnp.asarray(P.numpy()),
        jnp.asarray(N.numpy()), max_texels=12))
    h = hit.numpy()
    assert close_rel(got[h], want[h], 1e-5).mean() >= 0.99
    assert want[h].max() > 0


@pytest.mark.parametrize("light", sorted(LIGHT_CASES))
def test_light_wi_cl_matches_jax(light):
    """light_wi_cl (the binding of RSL illuminance blocks) for every
    light type, the environment lights among them: the direction and
    the shadowed colour, lane for lane."""
    from lucille_tpu.lights.sampling import light_wi_cl as j_wi_cl
    from lucille_tpu_torch.lights.sampling import light_wi_cl
    from lucille_tpu_torch.sampling.jitter import StreamKey

    kind, i = LIGHT_CASES[light]
    (sj, lj), (st, lt), P, N, hit = _shading_points(kind)
    key = jax.random.key(21)
    wi, cl = light_wi_cl(st, lt.lights[i], P, N, StreamKey(JaxStream(key)),
                         index=i)
    jwi, jcl = j_wi_cl(sj, lj.lights[i], jnp.asarray(P.numpy()),
                       jnp.asarray(N.numpy()), key, index=i)
    h = hit.numpy()
    assert wi.shape == cl.shape == (512, 3)
    assert close_rel(wi.numpy()[h], np.asarray(jwi)[h], 1e-5).all()
    ok = close_rel(cl.numpy()[h], np.asarray(jcl)[h], 1e-5)
    assert ok.mean() >= 0.99, ok.mean()
    assert np.asarray(jcl)[h].max() > 0


def test_light_wi_cl_has_no_sample_for_other_lights():
    from lucille_tpu_torch.lights.sampling import light_wi_cl
    from lucille_tpu_torch.lights.tables import LightEntry
    from lucille_tpu_torch.sampling.jitter import StreamKey, TileSampler

    light = LightEntry(type="area", position=(0, 0, 0), direction=(0, 0, 1),
                       color=(1, 1, 1), intensity=1.0)  # no triangles
    P = torch.zeros((4, 3))
    key = StreamKey(TileSampler(0, "cpu")(0, 0))
    assert light_wi_cl(None, light, P, P, key) == (None, None)


@pytest.mark.parametrize("integrator,kind,depth", [
    ("whitted", "ibl-importance", 2), ("whitted", "ibl-structured", 1),
    ("pathtrace", "ibl-cosweight", 2)])
def test_integrators_under_a_map_match_jax(integrator, kind, depth):
    """The Whitted wavefront under an importance-sampled and a
    structured IBL light, and the path tracer under the lat-long map
    (escaped rays fetch it; its light sampling gathers through the
    sampler), lane for lane."""
    got, gaux, want, waux = run_wavefront(integrator, kind, depth)
    check_lane_for_lane(got, gaux, want, waux)
    assert want[waux["hit"]].std(axis=0).min() > 1e-3


def _frame_pair(make_state, tile):
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(make_state("jax").scene, tile_size=tile)
    ref = jr.render_frame()
    r = Renderer(make_state("torch").scene, tile_size=tile, device="cpu",
                 sampler=JaxSampler())
    return r, r.render_frame(), jr, ref


@pytest.mark.parametrize("accel", ["dense", "bvh"])
def test_whitted_frame_under_a_map_matches_jax(accel):
    """A small Whitted frame of the bundled scene (dense tiles,
    importance sampling) and of the terrain (tile BVH, cosweight) under
    an IBL light, against lucille_tpu's Renderer."""
    from test_torch_whitted import state

    if accel == "dense":
        def make_state(pkg):
            return state("ibl-importance", pkg, method="whitted",
                         max_depth=2)
    else:
        def make_state(pkg):
            s = _hf_ibl(pkg, "cosweight", 32, 16)
            s.options.render_method = "whitted"
            s.options.max_ray_depth = 1
            return s
    r, got, jr, ref = _frame_pair(make_state, 16)
    assert r.scene.accel == ("dense" if accel == "dense" else "pbvh")
    assert r.stats.nrays == jr.stats.nrays
    assert 0.05 < ref.mean() and ref.std() > 0.01
    assert close_rel(got.reshape(-1, 3), ref.reshape(-1, 3), 1e-4).mean() \
        >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * max(ref.mean(), 1.0)
