"""The shader integrator (transport/shaded.py) against lucille_tpu's:
tests/test_transport.py's TestShadedIntegrator scenes, frame for frame
or wavefront for wavefront, and the shader table.

lucille_tpu's Pallas kernels run in interpret mode, on wavefronts of
whole 256-ray blocks (so that its dispatch takes them, not its MXU
path); the port draws lucille_tpu's own random numbers
(test_torch_render.JaxSampler / JaxStream), so the two shade the same
samples.

Tolerances, as test_torch_whitted.py's integrators: nrays and the eye
hit masks exactly; radiance within 1e-4 of max(|value|, 1) on all but 1%
of the lanes or pixels (a shadow ray or a stratum grazing an edge can
flip, and a trace() wavefront carries the flip on), the means within
1e-3 of max(mean, 1).

lucille_tpu registers a compiled .sl process-wide under its declared
name, and a test worker runs several files: every .sl here declares a
name used nowhere else in the tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_render import JaxSampler, JaxStream
from test_torch_scene import bundled_rib_text, front_end
from test_torch_scene import one_torch_thread  # noqa: F401
from test_torch_whitted import close_rel, state

WHITTED_SL = (
    "surface shwhitted(float eta = 1.5; float Kd = .8; float Kr = .8;"
    "  float Kt = .2; float Ks = .2; float Kss = 2) {\n"
    "  normal Nn = faceforward(normalize(N), I);\n"
    "  Ci = Kd * ambient();\n"
    "  illuminance(P, Nn, PI/2) { Ci += Kd * Cl * (L . Nn); }\n"
    "  Ci += Ks * trace(P, reflect(I, Nn));\n"
    "  vector T = refract(I, Nn, (N.I) < 0 ? eta : 1/eta);\n"
    "  if (length(T) != 0.0) Ci += Kt * trace(P, T);\n"
    "}\n"
)
DOME = 'LightSource "domelight" 1 "intensity" [1.0]\n'


def _frame_pair(make_state, tile):
    """The same scene through both Renderers: (port Renderer, port frame,
    lucille_tpu Renderer, its frame), held to the module's bounds."""
    from lucille_tpu.render.renderer import Renderer as JaxRenderer
    from lucille_tpu_torch.render.renderer import Renderer

    jr = JaxRenderer(make_state("jax").scene, tile_size=tile)
    ref = jr.render_frame()
    r = Renderer(make_state("torch").scene, tile_size=tile, device="cpu",
                 sampler=JaxSampler())
    got = r.render_frame()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert r.stats.nrays == jr.stats.nrays
    ok = close_rel(got.reshape(-1, 3), ref.reshape(-1, 3), 1e-4)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(got.mean() - ref.mean()) <= 1e-3 * max(abs(ref.mean()), 1.0)
    return r, got, jr, ref


def _quad_state(pkg, tmp_path, surface, lights="", size=(32, 24),
                fov=45):
    """tests/test_transport.py's quad facing the camera under the shader
    method, tmp_path on the shader search path."""
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib(f'Projection "perspective" "fov" [{fov}]\n'
              f'Option "searchpath" "shader" ["{tmp_path}"]\n'
              'Option "renderer" "method" ["shader"]\n'
              "WorldBegin\n" + lights + surface +
              'Polygon "P" [ 2 2 4  2 -2 4  -2 -2 4  -2 2 4 ]\n'
              "WorldEnd\n", s)
    s.Format(*size)
    s.options.accel_method = "pallas"  # lucille_tpu's Pallas dense tiles
    return s


def test_rsl_shader_from_the_search_path_drives_the_frame(tmp_path):
    """TestShadedIntegrator's flatred: a non-built-in .sl compiled from
    disk colours the hit pixels K (1, .25, .1)."""
    (tmp_path / "shflatred.sl").write_text(
        "surface shflatred(float K = 1) { Ci = K * (1, 0.25, 0.1); }")
    r, got, _jr, _ref = _frame_pair(lambda pkg: _quad_state(
        pkg, tmp_path, 'Surface "shflatred" "K" [0.5]\n'), 32)
    hits = got[..., 0] > 0.4
    assert hits.mean() > 0.3
    np.testing.assert_allclose(got[hits], np.broadcast_to(
        [0.5, 0.125, 0.05], got[hits].shape), atol=1e-5)
    assert r.shader_table[0].fn.shader_name == "shflatred"


def test_two_shaders_masked_dispatch():
    """Two constant panels in different colours: each lane takes its own
    geometry's shader; the gap shows the default dome."""
    def make(pkg):
        RiState, parse_rib = front_end(pkg)
        s = RiState()
        parse_rib(
            'Projection "perspective" "fov" [60]\n'
            'Option "renderer" "method" ["shader"]\n'
            "WorldBegin\n"
            "AttributeBegin\n"
            'Surface "constant"\nColor [1 0 0]\n'
            'Polygon "P" [ -0.2 2 4  -0.2 -2 4  -2.4 -2 4  -2.4 2 4 ]\n'
            "AttributeEnd\n"
            "AttributeBegin\n"
            'Surface "constant"\nColor [0 0 1]\n'
            'Polygon "P" [ 2.4 2 4  2.4 -2 4  0.2 -2 4  0.2 2 4 ]\n'
            "AttributeEnd\n"
            "WorldEnd\n", s)
        s.Format(48, 32)
        s.options.accel_method = "pallas"
        return s

    _r, got, _jr, _ref = _frame_pair(make, 48)
    h, w = got.shape[:2]
    np.testing.assert_allclose(got[h // 2, w // 4], [1, 0, 0], atol=1e-5)
    np.testing.assert_allclose(got[h // 2, 3 * w // 4], [0, 0, 1], atol=1e-5)


def _plane(pkg, extra_rib="", lights_rib=""):
    """tests/test_transport.py's _plane_scene in package pkg, on the
    dense tiles: (desc, scene, lights)."""
    RiState, parse_rib = front_end(pkg)
    s = RiState()
    parse_rib("WorldBegin\n" + lights_rib +
              'PointsPolygons [4] [0 3 2 1] "P" '
              "[-50 0 -50  50 0 -50  50 0 50  -50 0 50]\n" + extra_rib +
              "WorldEnd\n", s)
    s.options.accel_method = "pallas"  # not lucille_tpu's small-scene MXU
    if pkg == "jax":
        from lucille_tpu.lights.tables import build_light_tables
        from lucille_tpu.scene.compile import compile_scene

        return (s.scene, compile_scene(s.scene).device_put(),
                build_light_tables(s.scene))
    from lucille_tpu_torch.lights.tables import build_light_tables
    from lucille_tpu_torch.scene.compile import compile_scene

    return s.scene, compile_scene(s.scene, "cpu"), build_light_tables(
        s.scene, device="cpu")


def _wavefront_pair(extra_rib, org, dirn, seed, max_depth=8):
    """shaded_radiance of both packages on the same rays of the plane
    scene under a dome with extra_rib: (got, got aux, want, want aux)."""
    from lucille_tpu.transport.shaded import build_shader_table as jtable
    from lucille_tpu.transport.shaded import shaded_radiance as jshade
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.transport.shaded import (
        build_shader_table,
        shaded_radiance,
    )

    jdesc, sj, lj = _plane("jax", extra_rib, DOME)
    desc, st, lt = _plane("torch", extra_rib, DOME)
    key = jax.random.key(seed)
    want, waux = jshade(sj, lj, jnp.asarray(org), jnp.asarray(dirn), key,
                        shader_table=jtable(jdesc), max_depth=max_depth)
    got, gaux = shaded_radiance(st, lt, torch.from_numpy(org),
                                torch.from_numpy(dirn),
                                StreamKey(JaxStream(key)),
                                shader_table=build_shader_table(desc, "cpu"),
                                max_depth=max_depth)
    return (got.numpy(), {k: np.asarray(v) for k, v in gaux.items()},
            np.asarray(want), {k: np.asarray(v) for k, v in waux.items()})


def _check_wavefront(got, gaux, want, waux):
    np.testing.assert_array_equal(gaux["hit"], waux["hit"])
    assert int(gaux["nrays"]) == int(waux["nrays"]) == len(got)
    np.testing.assert_array_equal(gaux["t"][gaux["hit"]],
                                  waux["t"][waux["hit"]])
    ok = close_rel(got, want, 1e-4)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * max(want.mean(), 1.0)


def test_trace_builtin_mirror_reflects_the_plane():
    """TestShadedIntegrator's small tilted mirror: trace() shades the
    reflected wavefront, which lands on the dome-lit ground beside the
    mirror's shadow."""
    B = 256
    org = np.stack([np.linspace(-0.5, 0.5, B), np.full(B, 2.0),
                    np.zeros(B)], -1).astype(np.float32)
    up = np.float32([0.5, 1.0, 0.0])
    dirn = np.broadcast_to(up / np.linalg.norm(up), (B, 3)).astype(
        np.float32)
    got, gaux, want, waux = _wavefront_pair(
        "AttributeBegin\n"
        'Surface "mirror" "Kr" [1.0]\n'
        'PointsPolygons [4] [0 1 2 3] "P" [-4 4 -4  2 4 -4  2 4 4  -4 4 4]\n'
        "AttributeEnd\n", org, dirn, 3)
    _check_wavefront(got, gaux, want, waux)
    assert gaux["hit"].all() and want.mean() > 0.05


def test_trace_depth_terminates():
    """Two parallel mirrors: the recursion stops at depth 3 (shader.c:911)
    and the radiance stays finite, in both packages alike."""
    B = 256
    org = np.stack([np.linspace(-3, 3, B), np.full(B, 3.0),
                    np.linspace(-3, 3, B)], -1).astype(np.float32)
    dirn = np.broadcast_to(np.float32([0, -1, 0]), (B, 3)).copy()
    mirrors = ("AttributeBegin\n"
               'Surface "mirror" "Kr" [1.0]\n'
               'PointsPolygons [4] [0 1 2 3] "P" '
               "[-20 4 -20  20 4 -20  20 4 20  -20 4 20]\n"
               'PointsPolygons [4] [0 3 2 1] "P" '
               "[-20 1 -20  20 1 -20  20 1 20  -20 1 20]\n"
               "AttributeEnd\n")
    for depth in (8, 2, 0):
        got, gaux, want, waux = _wavefront_pair(mirrors, org, dirn, 4, depth)
        _check_wavefront(got, gaux, want, waux)
        assert np.isfinite(got).all()


def test_whitted_sl_frame_matches_jax(tmp_path):
    """TestShadedIntegrator's whitted.sl (ambient, illuminance, a
    reflected and a refracted trace() under a varying if) under a dome:
    the frame, and 15 closest hits a tile (1 + 2 + 4 + 8 wavefronts)."""
    from lucille_tpu_torch.accel import isect

    (tmp_path / "shwhitted.sl").write_text(WHITTED_SL)
    isect.COUNTS.reset()
    r, got, _jr, _ref = _frame_pair(lambda pkg: _quad_state(
        pkg, tmp_path, 'Surface "shwhitted"\n', DOME), 32)
    assert isect.COUNTS.plain == 15
    assert got.mean() > 0.1


@pytest.mark.parametrize("case", ["materials", "sunsky-sl"])
def test_lit_frames_match_jax(case, tmp_path):
    """materials: test_torch_whitted's scene under the shader method (a
    distant, a point and an area light; plastic, an unknown "glass" that
    falls back to matte, matte); sunsky-sl: the bundled scene as shipped
    (its sunsky and sun lights) with whitted.sl bound to everything."""
    if case == "materials":
        def make(pkg):
            return state("materials", pkg, method="shader")
    else:
        (tmp_path / "shwhitted.sl").write_text(WHITTED_SL)

        def make(pkg):
            RiState, parse_rib = front_end(pkg)
            s = RiState()
            parse_rib(bundled_rib_text(sunsky=True).replace(
                "WorldBegin\n", f'Option "searchpath" "shader" '
                f'["{tmp_path}"]\nWorldBegin\nSurface "shwhitted"\n', 1), s)
            s.Format(16, 16)
            s.PixelSamples(1, 1)
            s.options.render_method = "shader"
            s.options.accel_method = "pallas"
            return s

    r, got, _jr, ref = _frame_pair(make, 16)
    assert 0.05 < ref.mean()
    names = {row.fn.__name__ for row in r.shader_table}
    assert names == ({"plastic_shader", "matte_shader"}
                     if case == "materials" else {"sl_shwhitted"})


# -- the shader table ------------------------------------------------------

def _table_pair(tmp_path, surfaces):
    """Both packages' shader tables of one quad per entry of `surfaces`
    (Surface lines), tmp_path on the shader search path:
    [(fn name, params)] of each."""
    from lucille_tpu.transport.shaded import build_shader_table as jtable
    from lucille_tpu_torch.transport.shaded import build_shader_table

    out = []
    for pkg, build in (("jax", jtable),
                       ("torch", lambda d: build_shader_table(d, "cpu"))):
        RiState, parse_rib = front_end(pkg)
        s = RiState()
        quads = "".join(
            f"AttributeBegin\n{line}Polygon \"P\" [0 0 {i} 1 0 {i} 1 1 {i}]"
            "\nAttributeEnd\n" for i, line in enumerate(surfaces))
        parse_rib(f'Option "searchpath" "shader" ["{tmp_path}"]\n'
                  f"WorldBegin\n{quads}WorldEnd\n", s)
        out.append([(row[0].__name__, row[1]) for row in build(s.scene)])
    return out


def _same(a, b):
    assert [n for n, _p in a] == [n for n, _p in b]
    for (_n, pa), (_m, pb) in zip(a, b):
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_array_equal(np.asarray(pa[k]),
                                          np.asarray(pb[k]))


def test_shader_table_matches_jax(tmp_path):
    """Inline declarations normalised ('uniform float Ks' -> 'Ks'), the
    defaults merged under the bound parameters, an .sl compiled from the
    search path with its own defaults, a malformed .sl and an unknown
    name falling back to matte, an .sl declaring another name than its
    file's (matte: it registers under its declared name), and a built-in
    winning over an .sl of the same name."""
    (tmp_path / "shtablek.sl").write_text(
        "surface shtablek(float K = 0.5; color C = (1, 0, 0)) { Ci = K * C; }")
    (tmp_path / "shbroken.sl").write_text("surface shbroken( { Ci = ; }")
    (tmp_path / "shfilename.sl").write_text(
        "surface shdeclared() { Ci = Cs; }")
    (tmp_path / "plastic.sl").write_text("surface plastic() { Ci = 0; }")
    got, want = _table_pair(tmp_path, [
        'Surface "plastic" "uniform float Ks" [0.3] "Kd" [0.2]\n',
        'Surface "shtablek" "float K" [2]\n',
        'Surface "shtablek"\n',
        'Surface "shbroken" "Kd" [0.5]\n',
        'Surface "NoSuchSurface"\n',
        'Surface "shfilename"\n',
        'Surface "matte"\n',
        "",
    ])
    _same(got, want)
    assert [n for n, _p in got] == [
        "plastic_shader", "sl_shtablek", "sl_shtablek", "matte_shader",
        "matte_shader", "matte_shader", "matte_shader", "matte_shader"]
    assert got[0][1]["Ks"] == [0.3] and got[0][1]["Ka"] == 1.0
    assert got[1][1]["K"] == [2.0] and got[2][1]["K"] == 0.5


def test_shader_tables_are_per_renderer(tmp_path):
    """Two scenes whose search paths hold different sources of one name
    each get their own (lucille_tpu's registry would hand the second
    scene the first one's); the rows are bound on the table's device."""
    from lucille_tpu_torch.ri.api import RiState
    from lucille_tpu_torch.rib.parser import parse_rib
    from lucille_tpu_torch.transport.shaded import build_shader_table

    tables = []
    for k in (1, 2):
        d = tmp_path / str(k)
        d.mkdir()
        (d / "shsame.sl").write_text(
            f"surface shsame(color C = ({k}, 0, 0)) {{ Ci = C; }}")
        s = RiState()
        parse_rib(f'Option "searchpath" "shader" ["{d}"]\nWorldBegin\n'
                  'Surface "shsame"\nPolygon "P" [0 0 0 1 0 0 1 1 0]\n'
                  "WorldEnd\n", s)
        tables.append(build_shader_table(s.scene, "cpu"))
    (a,), (b,) = tables
    assert a.fn is not b.fn
    assert a.bound["C"].tolist() == [1.0, 0.0, 0.0]
    assert b.bound["C"].tolist() == [2.0, 0.0, 0.0]


def test_matte_everywhere_without_a_table():
    """shader_table None shades every geometry matte, as lucille_tpu."""
    from lucille_tpu.transport.shaded import shaded_radiance as jshade
    from lucille_tpu_torch.sampling.jitter import StreamKey
    from lucille_tpu_torch.transport.shaded import shaded_radiance

    B = 256
    org = np.stack([np.linspace(-3, 3, B), np.full(B, 5.0),
                    np.linspace(-3, 3, B)], -1).astype(np.float32)
    dirn = np.broadcast_to(np.float32([0.1, -1, 0.05]), (B, 3)).copy()
    _d, sj, lj = _plane("jax", "", DOME)
    _d, st, lt = _plane("torch", "", DOME)
    key = jax.random.key(8)
    want, waux = jshade(sj, lj, jnp.asarray(org), jnp.asarray(dirn), key)
    got, gaux = shaded_radiance(st, lt, torch.from_numpy(org),
                                torch.from_numpy(dirn),
                                StreamKey(JaxStream(key)))
    _check_wavefront(got.numpy(), {k: np.asarray(v) for k, v in
                                   gaux.items()},
                     np.asarray(want), {k: np.asarray(v) for k, v in
                                        waux.items()})
