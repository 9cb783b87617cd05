"""The shading wavefronts and the Whitted integrator: the port against
lucille_tpu on the same inputs.

numpy makes every input from a seed; lucille_tpu's Pallas kernels run in
interpret mode, with wavefronts of whole 256-ray blocks so that its
dispatch takes the Pallas kernels and not its MXU fallback.  The port's
random numbers come from `test_torch_render.JaxStream`, whose draws are
lucille_tpu's own `jax.random` draws for the same fold-in chains, so the
two packages shade the same samples.

Tolerances:

- reflection.py's functions: within 1e-6 of max(|value|, 1) (XLA:CPU
  contracts products into FMAs, and its sin, cos and pow differ from
  torch's by ulps: the cos^N lobe's pdf reaches 2);
- interp_hit: the attribute gathers exactly, interpolations within 1e-6;
  background_radiance within 1e-5 of max(|value|, 1) (the sky, as
  test_torch_sunsky.py holds it);
- light_contribution: hit lanes within 1e-5 of max(|value|, 1), except
  on at most 1% of them, where a shadow ray grazing an edge or an AO
  stratum can flip (the FMA contraction again); the same for a dome or
  IBL light with an environment map under each of its five samplers
  (`ibl_map_dir`'s 10x5 map, 50 texels, so bruteforce traces 50 shadow
  wavefronts), and for background_radiance through the map;
- the integrators on the bundled scene (4 triangle tiles: a lane keeps
  its jitter): the eye hit masks and the ray counts exactly; radiance
  within 1e-4 of max(|value|, 1) on all but 1% of the lanes, and the
  means within 1e-3 of max(mean, 1);
- on the heightfield's tile BVH the Morton lane order can hand a lane's
  gather jitter to a neighbour after an ulp of difference, so the hit
  masks hold exactly and the mean radiance over hits within 0.005;
- the materials scene's compiled mat_* rows: exactly.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxSampler, JaxStream
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_scene import native_builders  # noqa: F401
from test_torch_scene import bundled_rib_text, front_end, heightfield_state

MAT_LIGHTS = (
    'LightSource "distantlight" 1 "intensity" [0.8] "from" [1 6 2] '
    '"to" [0 0 0]\n'
    'LightSource "pointlight" 2 "intensity" [12.0] "from" [-1 4 1]\n'
    "AttributeBegin\n"
    'AreaLightSource "arealight" 3 "intensity" [3.0]\n'
    'PointsPolygons [4] [0 3 2 1] "P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]\n'
    "AttributeEnd\n"
)
# a polished plastic and a transmissive material on two of the objects
MAT_SURFACES = {1: 'Surface "plastic" "Ks" [0.4] "roughness" [0.15]\n',
                2: 'Surface "glass" "Kd" [0.2] "Ks" [0.3] "Kt" [0.6]\n'}


IBL_SAMPLERS = ("cosweight", "importance", "stratified", "structured",
                "bruteforce")


@functools.cache
def ibl_map_dir() -> tempfile.TemporaryDirectory:
    """A temporary directory (.name its path, removed at exit) holding
    env.hdr, a 10x5 lat-long map (a sky, a sun texel ~1000x brighter, a
    darker ground), and probe.hdr, its 24x24 angular resampling."""
    from lucille_tpu_torch.imageio.rgbe import write_hdr

    d = tempfile.TemporaryDirectory(prefix="lucille_ibl_")
    img = np.empty((5, 10, 3), np.float32)
    img[:2] = (0.6, 0.8, 1.4)
    img[2:] = (0.25, 0.2, 0.15)
    img[1, 3] = (900.0, 800.0, 650.0)
    write_hdr(f"{d.name}/env.hdr", img)
    ys, xs = np.mgrid[0:24, 0:24]
    u, v = (xs + 0.5) / 12 - 1, 1 - (ys + 0.5) / 12
    up = np.clip(1 - np.hypot(u, v), 0, 1)[..., None]
    write_hdr(f"{d.name}/probe.hdr", (0.2 + 2.0 * up * img[0, 0]).astype(
        np.float32))
    return d


def ibl_line(kind: str) -> str:
    """kind "ibl-<sampler>": an IBL light on env.hdr with that sampler;
    "ibl-angular": a dome light on the angular probe.hdr (cosweight)."""
    d = ibl_map_dir().name
    if kind == "ibl-angular":
        return f'LightSource "dome" 1 "texture" ["{d}/probe.hdr"]\n'
    return (f'LightSource "ibl" 1 "texture" ["{d}/env.hdr"] '
            f'"sampling" ["{kind[4:]}"] "intensity" [0.8]\n')


def material_rib() -> str:
    """The bundled scene without its sunsky line, lit by a distant, a
    point and an area light, with MAT_SURFACES bound."""
    head, world = bundled_rib_text().split("WorldBegin\n")
    blocks = world.split("AttributeBegin\n")
    for i, surf in MAT_SURFACES.items():
        first, rest = blocks[i].split("\n", 1)
        blocks[i] = first + "\n" + surf + rest
    return head + "WorldBegin\n" + MAT_LIGHTS + "AttributeBegin\n".join(blocks)


def state(kind: str, pkg: str, width=16, height=16, method="ao",
          max_depth=None):
    """kind: "bundled" (no light: the default dome), "sunsky" (as
    shipped), "materials" (material_rib), "ibl-<sampler>" and
    "ibl-angular" (the bundled scene under `ibl_line(kind)`)."""
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    if kind.startswith("ibl-"):
        text = bundled_rib_text().replace(
            "WorldBegin\n", "WorldBegin\n" + ibl_line(kind), 1)
    else:
        text = {"bundled": lambda: bundled_rib_text(),
                "sunsky": lambda: bundled_rib_text(sunsky=True),
                "materials": material_rib}[kind]()
    parse_rib(text, s)
    s.Format(width, height)
    s.PixelSamples(1, 1)
    s.options.render_method = method
    s.options.accel_method = "pallas"
    if max_depth is not None:
        s.options.max_ray_depth = max_depth
    return s


def compiled(kind: str, pkg: str):
    """(scene, light tables, camera) of a case, in package pkg."""
    if pkg == "jax":
        from lucille_tpu.lights.tables import build_light_tables
        from lucille_tpu.scene.compile import compile_scene

        s = (heightfield_state(35, accel="bvh", pkg="jax") if kind == "hf"
             else state(kind, "jax"))
        return (compile_scene(s.scene).device_put(),
                build_light_tables(s.scene), s.scene.camera)
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.scene.compile import compile_scene

    s = (heightfield_state(35, accel="bvh") if kind == "hf"
         else state(kind, "torch"))
    return (compile_scene(s.scene, "cpu"),
            build_light_tables(s.scene, device="cpu"),
            s.scene.camera)


def eye_rays(camera, B: int, seed: int = 0, size=(16, 16)):
    """B eye rays of lucille_tpu's camera at random raster points, as
    numpy arrays (both packages get the same rays)."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, size[0], B).astype(np.float32)
    py = rng.uniform(0, size[1], B).astype(np.float32)
    o, d = camera.generate_rays(jnp.asarray(px), jnp.asarray(py))
    return np.array(o), np.array(d)


def close_rel(got, want, tol):
    """(n,) bool: |got - want| <= tol max(|want|, 1), per lane (rows)."""
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    return err.reshape(err.shape[0], -1).max(axis=1) <= tol


def t(a):
    return torch.from_numpy(np.asarray(a))


# -- reflection.py ---------------------------------------------------------

def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("fn", ["reflect", "refract", "fresnel",
                                "fresnel_schlick", "cosweight_sample",
                                "cosn_sample"])
def test_reflection_matches_jax(fn):
    from lucille_tpu.shading import reflection as jref
    from lucille_tpu.transport.ao import ortho_basis as j_basis
    from lucille_tpu_torch.ops import frame
    from lucille_tpu_torch.shading import reflection as tref

    rng = np.random.default_rng(3)
    n = 4096
    inc, nrm = _unit(rng, n), _unit(rng, n)
    eta = rng.uniform(1.0, 2.4, n).astype(np.float32)  # per lane
    u0, u1 = rng.uniform(size=(2, n)).astype(np.float32)
    if fn == "reflect":
        pairs = [(tref.reflect(t(inc), t(nrm)),
                  jref.reflect(jnp.asarray(inc), jnp.asarray(nrm)))]
    elif fn in ("refract", "fresnel"):
        got = getattr(tref, fn)(t(inc), t(nrm), t(eta))
        want = getattr(jref, fn)(jnp.asarray(inc), jnp.asarray(nrm),
                                 jnp.asarray(eta))
        pairs = list(zip(got, want))
        if fn == "refract":  # both ways through the surface, and TIR
            assert 0.05 < float(np.mean(np.asarray(want[1]))) < 0.95
            assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    elif fn == "fresnel_schlick":
        pairs = [(tref.fresnel_schlick(t(u0)),
                  jref.fresnel_schlick(jnp.asarray(u0)))]
    elif fn == "cosweight_sample":
        pairs = list(zip(
            frame.cosweight_sample(t(u0), t(u1), frame.ortho_basis(t(nrm))),
            jref.cosweight_sample(jnp.asarray(u0), jnp.asarray(u1),
                                  j_basis(jnp.asarray(nrm)))))
    else:
        pairs = list(zip(
            tref.cosn_sample(t(u0), t(u1), t(nrm), 12.0),
            jref.cosn_sample(jnp.asarray(u0), jnp.asarray(u1),
                             jnp.asarray(nrm), 12.0)))
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        if got.dtype == bool:
            np.testing.assert_array_equal(got, want)
        else:
            assert close_rel(got, want, 1e-6).all()


# -- transport/common.py ---------------------------------------------------

def _eye_hits(kind, B=512, seed=0):
    """Both packages' cases and the port's closest hit of B eye rays."""
    from lucille_tpu_torch.accel.dispatch import closest_hit

    sj, lj, cam = compiled(kind, "jax")
    st, lt, _ = compiled(kind, "torch")
    o, d = eye_rays(cam, B, seed)
    res = closest_hit(st, t(o), t(d))
    return (sj, lj), (st, lt), o, d, res


def test_interp_hit_matches_jax():
    from lucille_tpu.transport.common import interp_hit as j_interp
    from lucille_tpu_torch.transport.common import interp_hit

    (sj, _), (st, _), o, d, res = _eye_hits("materials")
    got = interp_hit(st, res, t(o), t(d))
    want = j_interp(sj, {k: jnp.asarray(v.numpy()) for k, v in res.items()},
                    jnp.asarray(o), jnp.asarray(d))
    hit = res["hit"].numpy()
    assert 0.3 < hit.mean() < 1.0
    assert len(np.unique(got["geom"].numpy()[hit])) >= 4
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if k == "geom":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    # the materials reach the hits: a plastic, a glass, the default matte
    ks, kt = got["ks"].numpy()[hit], got["kt"].numpy()[hit]
    assert {0.0, 0.3, 0.4} <= set(np.round(ks.astype(float), 6).tolist())
    assert (kt == np.float32(0.6)).any()


@pytest.mark.parametrize("kind", ["bundled", "sunsky", "bgcolor",
                                  "ibl-cosweight", "ibl-angular"])
def test_background_radiance_matches_jax(kind):
    """A constant dome, the sky of a sunsky light (its "sun" light adds
    nothing to escaped rays), no light with a bgcolor, and an IBL light's
    lat-long map and a dome's angular map along the escaped rays."""
    from lucille_tpu.transport.common import background_radiance as j_bg
    from lucille_tpu_torch.transport.common import background_radiance

    rng = np.random.default_rng(4)
    d = _unit(rng, 2048)
    bg = (0.25, 0.5, 0.75)
    if kind == "bgcolor":
        lj = lt = ()
    else:
        lj, lt = compiled(kind, "jax")[1], compiled(kind, "torch")[1]
    got = background_radiance(lt, t(d), bg).numpy()
    want = np.asarray(j_bg(lj, jnp.asarray(d), bg))
    assert got.shape == (2048, 3)
    assert close_rel(got, want, 1e-5).all()
    if kind == "sunsky":
        assert want.max() > 1000
    if kind.startswith("ibl"):  # the map's texels, not a constant
        assert want.std(axis=0).min() > 0.01


def test_materials_compile_matches_jax():
    """Surface "plastic" "Ks" / "glass" "Kt" and an area light: the
    compiled material rows and light tables equal lucille_tpu's."""
    sj, lj, _ = compiled("materials", "jax")
    st, lt, _ = compiled("materials", "torch")
    for f in ("mat_kd", "mat_ks", "mat_kt", "mat_ior", "mat_roughness",
              "mat_color", "mat_emission", "mat_texture", "geom_id"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert np.asarray(sj.mat_emission).max() > 0  # the area light's quad
    assert [li.type for li in lt] == [li.type for li in lj] == [
        "distant", "point", "area"]
    for a, b in zip(lt, lj):
        assert (a.position, a.direction, a.color, a.intensity) == (
            b.position, b.direction, b.color, b.intensity)
        if a.tris is not None:
            for k in ("v0", "e1", "e2", "area_cdf"):
                np.testing.assert_array_equal(a.tris[k], b.tris[k])


# -- lights/sampling.py ----------------------------------------------------

LIGHT_CASES = {"distant": ("materials", 0), "point": ("materials", 1),
               "area": ("materials", 2), "sunsky": ("sunsky", 0),
               "sun": ("sunsky", 1), "dome": ("bundled", 0),
               "dome-angular": ("ibl-angular", 0),
               **{f"ibl-{s}": (f"ibl-{s}", 0) for s in IBL_SAMPLERS}}


@pytest.mark.parametrize("light", sorted(LIGHT_CASES))
def test_light_contribution_matches_jax(light):
    from lucille_tpu.lights.sampling import light_contribution as j_lc
    from lucille_tpu_torch.lights.sampling import light_contribution
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.transport.common import face_forward, interp_hit

    kind, i = LIGHT_CASES[light]
    (sj, lj), (st, lt), o, d, res = _eye_hits(kind, seed=1)
    h = interp_hit(st, res, t(o), t(d))
    P, N = h["P"], face_forward(h["Ns"], t(d))
    hit = res["hit"]
    n = 4 if light.split("-")[0] in ("area", "sunsky", "dome", "ibl") else 1
    assert lt.lights[i].type == light.split("-")[0]
    key = jax.random.fold_in(jax.random.key(5), 1000 + i)
    got = light_contribution(st, lt.lights[i], P, N,
                             StreamKey(JaxStream(key)), n, active=hit)
    want = j_lc(sj, lj.lights[i], jnp.asarray(P.numpy()),
                jnp.asarray(N.numpy()), key, n,
                active=jnp.asarray(hit.numpy()))
    got, want, hit = got.numpy(), np.asarray(want), hit.numpy()
    assert got.shape == (512, 3)
    lit = want[hit].max(axis=1) > 0
    assert 0.2 < lit.mean()
    if n == 1:  # some shadow rays are blocked
        assert (~lit).any()
    else:  # some samples are blocked
        assert (want[hit] < want[hit].max() - 1e-3).any()
    ok = close_rel(got[hit], want[hit], 1e-5)
    assert ok.mean() >= 0.99, ok.mean()


def test_shadow_rays_per_hit_matches_jax():
    from lucille_tpu.lights.sampling import shadow_rays_per_hit as j_n
    from lucille_tpu_torch.lights.sampling import shadow_rays_per_hit

    for kind in ("bundled", "sunsky", "materials"):
        lj, lt = compiled(kind, "jax")[1], compiled(kind, "torch")[1]
        assert shadow_rays_per_hit(lt) == j_n(lj) > 0


# -- the Whitted integrator ------------------------------------------------

def run_wavefront(integrator: str, kind: str, max_depth: int, B=512,
                  seed=2):
    """Both packages' integrator on the same eye rays and key: (got
    radiance, got aux, want radiance, want aux), numpy."""
    if integrator == "whitted":
        from lucille_tpu.transport.whitted import whitted_radiance as jfn
        from lucille_tpu_torch.transport.whitted import whitted_radiance as fn
    else:
        from lucille_tpu.transport.pathtrace import path_radiance as jfn
        from lucille_tpu_torch.transport.pathtrace import path_radiance as fn
    from lucille_tpu_torch.sampling.jitter import StreamKey

    sj, lj, cam = compiled(kind, "jax")
    st, lt, _ = compiled(kind, "torch")
    size = (64, 48) if kind == "hf" else (16, 16)
    o, d = eye_rays(cam, B, seed, size)
    key = jax.random.key(11)
    got, gaux = fn(st, lt, t(o), t(d), StreamKey(JaxStream(key)),
                   max_depth=max_depth)
    want, waux = jfn(sj, lj, jnp.asarray(o), jnp.asarray(d), key,
                     max_depth=max_depth)
    gaux = {k: v.numpy() for k, v in gaux.items()}
    waux = {k: np.asarray(v) for k, v in waux.items()}
    return got.numpy(), gaux, np.asarray(want), waux


def check_lane_for_lane(got, gaux, want, waux):
    np.testing.assert_array_equal(gaux["hit"], waux["hit"])
    assert int(gaux["nrays"]) == int(waux["nrays"])
    ok = close_rel(got, want, 1e-4)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * max(want.mean(), 1.0)


@pytest.mark.parametrize("kind,max_depth", [("bundled", 2),
                                            ("materials", 3)])
def test_whitted_wavefront_matches_jax(kind, max_depth):
    """The bundled scene under the default dome (matte: the bounce after
    the eye rays has no live lane) and the materials scene, whose
    plastic and glass lanes reflect and refract for two more bounces."""
    got, gaux, want, waux = run_wavefront("whitted", kind, max_depth)
    check_lane_for_lane(got, gaux, want, waux)
    B = 512
    if kind == "materials":  # bounce rays were traced
        shadow = 2 + 4 + 2  # distant, point, 4 area samples; 2 highlights
        assert int(waux["nrays"]) > B + waux["hit"].sum() * shadow
    else:
        assert int(waux["nrays"]) == B + waux["hit"].sum() * 4


def test_whitted_wavefront_on_the_tile_bvh_matches_jax():
    """bench_large's terrain at n = 35 on the tile BVH under the dome:
    the cone gather, in distribution."""
    got, gaux, want, waux = run_wavefront("whitted", "hf", 1)
    np.testing.assert_array_equal(gaux["hit"], waux["hit"])
    assert int(gaux["nrays"]) == int(waux["nrays"])
    hit = waux["hit"]
    assert hit.mean() > 0.3
    assert abs(got[hit].mean() - want[hit].mean()) <= 0.005


def test_whitted_frame_matches_jax():
    """A 16x16 Renderer frame of the bundled scene at lucille_tpu's
    default depth (8): one live bounce, then seven with no live lane."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(state("bundled", "jax", method="whitted").scene,
                     tile_size=16)
    ref = jr.render_frame()
    r = Renderer(state("bundled", "torch", method="whitted").scene,
                 tile_size=16, device="cpu", sampler=JaxSampler())
    got = r.render_frame()
    assert r.desc.options.max_ray_depth == 8
    assert r.stats.nrays == jr.stats.nrays
    assert 0.2 < ref.mean() < 1.0
    assert close_rel(got.reshape(-1, 3), ref.reshape(-1, 3), 1e-4).mean() \
        >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3


def test_default_stream_matches_the_ao_draw():
    """The empty path is the AO jitter the port drew before streams had
    paths: SeedSequence((seed, x0, y0)) into a torch.Generator."""
    from lucille_tpu_torch.sampling.jitter import StreamKey, TileSampler

    stream = TileSampler(3, "cpu")(48, 16)
    hi, lo = np.random.SeedSequence([3, 48, 16]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed((int(hi) << 32 | int(lo)) >> 1)
    want = torch.rand((2, 100), generator=gen)
    assert torch.equal(stream.uniform((), (2, 100)), want)
    key = StreamKey(stream)
    a = key.fold(1).fold(1000).uniform((2, 50))
    assert torch.equal(a, key.fold(1).fold(1000).uniform((2, 50)))
    assert not torch.equal(a, key.fold(1).fold(1001).uniform((2, 50)))
    i = key.fold(0).randint((1000,), 3)
    assert i.dtype == torch.int64 and set(i.tolist()) == {0, 1, 2}


def test_dispatch_methods():
    """whitted, the path names, dirtmap and the shader names (shader, sl,
    shade: the shader integrator, which takes the shader table) are
    ported; an unknown name renders AO."""
    import inspect

    from lucille_tpu_torch.transport import dispatch

    assert dispatch.get_integrator("whitted").__name__ == "whitted_fn"
    for name in ("pathtrace", "path", "mlt"):
        assert dispatch.get_integrator(name).__name__ == "path_fn"
    assert dispatch.get_integrator("dirtmap").__name__ == "dirt_fn"
    for name in ("shader", "sl", "shade", "Shader"):
        fn = dispatch.get_integrator(name)
        assert fn.__name__ == "shaded_fn"
        assert "shader_table" in inspect.signature(fn).parameters
    assert dispatch.get_integrator("bogus").__name__ == "ao_fn"
    assert dispatch.get_integrator("").__name__ == "ao_fn"


def test_whitted_max_depth_reaches_the_integrator():
    """Option "trace" "max_ray_depth" is the depth every method runs at:
    one bounce counts only the eye rays and their shadow rays."""
    from lucille_tpu_torch.render.renderer import Renderer

    r = Renderer(state("materials", "torch", method="whitted",
                       max_depth=1).scene, tile_size=16, device="cpu")
    r.render_frame()
    deep = Renderer(state("materials", "torch", method="whitted",
                          max_depth=3).scene, tile_size=16, device="cpu")
    deep.render_frame()
    assert 256 < r.stats.nrays < deep.stats.nrays


def test_light_constants_reach_the_device_once():
    """The bounce loops' constants (background, light colours and
    directions, an area light's triangles) are copied to the device once
    and shared: on a card each copy would make the host wait for every
    tile already enqueued.  An area light's tables are built with the
    light tables and ride on its entry.  The same values answer as
    before."""
    from lucille_tpu_torch.device import const_vec
    from lucille_tpu_torch.lights.sampling import (
        light_color,
        sample_area_light,
    )
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.transport.common import background_radiance

    RiState, parse_rib = front_end("torch")
    s = RiState()
    parse_rib(material_rib(), s)
    lights = build_light_tables(s.scene, device="cpu")
    like = torch.zeros((4, 3))
    for li in lights:
        assert const_vec(li.color, "cpu") is const_vec(li.color, "cpu")
        want = torch.tensor(li.color, dtype=torch.float32) * li.intensity
        assert torch.equal(light_color(li, like), want)
    assert const_vec((0.5, 1, 2), "cpu") is const_vec([0.5, 1.0, 2.0], "cpu")
    d = torch.nn.functional.normalize(torch.randn(8, 3), dim=-1)
    bg = background_radiance(lights, d, (0.25, 0.5, 0.75))
    assert torch.equal(bg, torch.tensor([[0.25, 0.5, 0.75]]).expand(8, 3))
    area = next(li for li in lights if li.type == "area")
    u = torch.rand((16, 3), generator=torch.Generator().manual_seed(0))
    tables = area.area
    first = sample_area_light(area, u)
    assert area.area is tables
    assert all(torch.equal(a, b) for a, b in zip(
        first, sample_area_light(area, u)))
    for t, k in zip(tables, ("area_cdf", "v0", "e1", "e2")):
        assert torch.equal(t, torch.from_numpy(area.tris[k]))
    assert all(t.device.type == "cpu" for t in tables)
